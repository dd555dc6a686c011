"""Runtime state, process sets, errors and networking helpers."""
