"""Measurement scripts of the port, run on a machine with one NVIDIA card."""
