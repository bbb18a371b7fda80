"""segmantic-tpu-torch: the PyTorch / CUDA port of segmantic-tpu.

A second package beside the JAX reference ``segmantic_tpu``: it imports
``torch`` and numpy and never JAX. Its modules keep the JAX package's names
and its channel-last public layouts; the Pallas kernels on the ported paths
are hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version that runs for CPU tensors.

Ported so far: serving, single-device training and evaluation (the
``serve``, ``train``, ``train-config``, ``predict``, ``ensemble-predict`` and
``cross-validate`` subcommands of ``segmantic-unet-torch``), image-to-image
translation (``i2i``: the ``pix2pix``, ``cyclegan`` and ``translate``
subcommands of ``segmantic-i2i-torch``), and the rest of the single-device
package: the landmark transforms (``detect``, heat maps smoothed on the card
by ``ops.gaussian``), surface distances (``metrics.distance``), modality and
image preparation (``image.modality``, ``image.processing``,
``image.utils``, ``image.make_mixed_modal_dataset``), the iSEG export
(``data.iseg``), FLOP counts (``utils.flops``), ``utils.device``, the native
bindings of ``native/`` (distance transform, patch crop, surfaces) and the
labels' one-gather augmentation (``AugmentConfig.label_affine_gather``),
and Parallel (``parallel/``): one process per card under torchrun, the
(data, model) mesh, data-parallel training with cross-rank BatchNorm, ZeRO-1,
tensor-parallel convs, the window- and volume-sharded sliding window and
multi-rank i2i training.

The top-level names below (``Volume``, ``UNet``, ``train_model``, ...) load
their modules on first use, as in the JAX package.
"""

__version__ = "0.1.0"

# no "train" alias: it would collide with the segmantic_tpu_torch.train
# subpackage (module attributes shadow module __getattr__)
_LAZY = {
    "Volume": ("segmantic_tpu_torch.core.volume", "Volume"),
    "UNet": ("segmantic_tpu_torch.models.unet", "UNet"),
    "train_model": ("segmantic_tpu_torch.train.trainer", "train"),
    "predict": ("segmantic_tpu_torch.infer.predict", "predict"),
    "cross_validate": ("segmantic_tpu_torch.train.cross_validate", "cross_validate"),
    "ensemble_creator": ("segmantic_tpu_torch.infer.ensemble", "ensemble_creator"),
    "SegmentationModel": ("segmantic_tpu_torch.train.trainer", "SegmentationModel"),
    "sliding_window_inference": (
        "segmantic_tpu_torch.infer.sliding_window",
        "sliding_window_inference",
    ),
    "read_volume": ("segmantic_tpu_torch.io.nifti", "read_volume"),
    "write_volume": ("segmantic_tpu_torch.io.nifti", "write_volume"),
}


def __getattr__(name):  # lazy top-level API (keeps CLI startup light)
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'segmantic_tpu_torch' has no attribute {name!r}")
