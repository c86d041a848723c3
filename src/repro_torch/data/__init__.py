"""Synthetic ECG5000-compatible data (numpy only)."""
