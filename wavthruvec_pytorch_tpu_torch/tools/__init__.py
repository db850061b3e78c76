"""Measurement scripts of the port, each run on its own on an NVIDIA GPU."""
