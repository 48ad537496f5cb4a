"""Shared infrastructure of the port (the registry)."""
