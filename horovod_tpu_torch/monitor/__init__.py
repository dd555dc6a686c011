"""Metric registry."""
