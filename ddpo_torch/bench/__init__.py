"""Measurement entry points of the port (each runs on a CUDA card)."""
