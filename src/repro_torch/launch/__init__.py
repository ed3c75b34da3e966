"""Serving launcher of the port (thread mode)."""
