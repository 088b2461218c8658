"""Kernels and device metrics of the port."""
