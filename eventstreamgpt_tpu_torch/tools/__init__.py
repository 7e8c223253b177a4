"""Measurement tools for the port, run on a machine with a CUDA device."""
