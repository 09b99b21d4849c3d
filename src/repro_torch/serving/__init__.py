"""Serving pieces of the port (sampling)."""
