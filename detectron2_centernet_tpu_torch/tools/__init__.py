"""Measurement scripts of the port, run as files (see each docstring)."""
