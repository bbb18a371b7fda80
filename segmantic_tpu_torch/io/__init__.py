from .nifti import read_nifti, read_volume, write_nifti, write_volume

__all__ = ["read_nifti", "write_nifti", "read_volume", "write_volume"]
