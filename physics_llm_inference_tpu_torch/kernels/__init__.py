"""Kernels: each TPU kernel's CUDA counterpart (csrc/) with its plain version."""
