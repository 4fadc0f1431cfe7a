"""Data pipeline of the port (numpy, no device code)."""
