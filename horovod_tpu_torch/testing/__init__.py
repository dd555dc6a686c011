"""Fault injection for chaos tests."""
