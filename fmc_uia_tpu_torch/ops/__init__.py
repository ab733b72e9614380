"""Kernels and device-side ops of the port."""
