"""Attention ops of the port: plain versions and the CUDA kernel wrappers."""
