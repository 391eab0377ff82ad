"""Kernels written by hand for Hopper, with their plain versions."""
