"""Array-layout and VTK interop helpers.

Port of ``segmantic_tpu/image/utils.py`` (reference:
src/segmantic/image/utils.py:13-52), a numpy copy. VTK is an optional extra:
:func:`vtk_image_from_volume` raises a clear error if the module is absent.
"""

from __future__ import annotations

import numpy as np

from ..core.volume import Volume

__all__ = ["array_view_reverse_ordering", "vtk_image_from_volume"]


def array_view_reverse_ordering(x: np.ndarray) -> np.ndarray:
    """Reversed-axis view (C-order (z,y,x) <-> Fortran-order (x,y,z))."""
    return x.transpose(np.flip(np.arange(len(x.shape))))


def vtk_image_from_volume(vol: Volume):
    """Convert a Volume to vtkImageData (spacing/origin/direction preserved)."""
    try:
        import vtk
        from vtk.util.numpy_support import numpy_to_vtk
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "vtk is not installed — surface export is an optional extra"
        ) from e

    data = np.squeeze(vol.numpy())
    nd = data.ndim
    image = vtk.vtkImageData()
    image.SetDimensions(*(list(data.shape) + [1] * (3 - nd)))
    image.SetSpacing(*(list(vol.spacing) + [1.0] * (3 - nd)))
    image.SetOrigin(*(list(vol.origin) + [0.0] * (3 - nd)))
    direction = np.eye(3)
    direction[:nd, :nd] = vol.direction
    if hasattr(image, "SetDirectionMatrix"):
        image.SetDirectionMatrix(direction.ravel())
    vtk_array = numpy_to_vtk(
        num_array=np.asfortranarray(data).ravel(order="F"), deep=True
    )
    image.GetPointData().SetScalars(vtk_array)
    return image
