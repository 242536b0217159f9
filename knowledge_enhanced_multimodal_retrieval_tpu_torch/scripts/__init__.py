"""Runnable scripts of the port (profilers)."""
