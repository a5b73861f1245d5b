"""Measurement scripts of the port, run on a GPU machine."""
