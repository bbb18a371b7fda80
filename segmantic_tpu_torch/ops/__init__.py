"""Ops of the port: the hand-written CUDA kernels and their plain versions."""
