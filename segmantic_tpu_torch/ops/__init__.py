"""Ops of the port: the hand-written CUDA kernels and their plain versions."""
from .resample import grid_matrix, resample_affine_np, resample_affine_torch

__all__ = ["grid_matrix", "resample_affine_torch", "resample_affine_np"]
