"""segmantic-tpu-torch: the PyTorch / CUDA port of segmantic-tpu.

A second package beside the JAX reference ``segmantic_tpu``: it imports
``torch`` and numpy and never JAX. Its modules keep the JAX package's names
and its channel-last public layouts; the Pallas kernels on the ported paths
are hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version that runs for CPU tensors.

Ported so far: serving, single-device training and evaluation (the
``serve``, ``train``, ``train-config``, ``predict``, ``ensemble-predict`` and
``cross-validate`` subcommands of ``segmantic-unet-torch``), and
image-to-image translation (``i2i``: the ``pix2pix``, ``cyclegan`` and
``translate`` subcommands of ``segmantic-i2i-torch``).
"""

__version__ = "0.1.0"
