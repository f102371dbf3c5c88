"""Kernels, their plain versions and the device pipeline."""
