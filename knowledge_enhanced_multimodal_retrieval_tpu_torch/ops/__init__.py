"""Kernels (csrc/*.cu) and their dispatch, plain versions beside each."""
