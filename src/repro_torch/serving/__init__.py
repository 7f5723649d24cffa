"""Serving surface of the port (the interactive design twin)."""
