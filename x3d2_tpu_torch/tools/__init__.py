"""Diagnostic scripts of the port (run on a GPU; nothing imports them)."""
