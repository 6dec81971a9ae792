"""Sampling backends of the port (the torch device engine)."""
