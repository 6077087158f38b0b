"""shapy_tpu_torch — the PyTorch/CUDA port of ``shapy_tpu``.

The JAX package ``shapy_tpu`` is the reference; this package mirrors its
module paths one to one and keeps its public layouts (NHWC images,
``(B, V, 3)`` vertices, ``(B, J, 3, 3)`` rotations) so the two can be
compared on the same numpy inputs.

Plain tensor code is PyTorch. The ops that the JAX package shaped by hand
for the TPU are CUDA kernels written for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``:

  * K1 measure  — ``measure/measurements.py`` (plane slice, hull, mass,
    height in one launch),
  * K2 ingest   — ``data/crop.py`` (uint8 decode, bilinear crop,
    ImageNet normalisation, cast),
  * K3 skinning — ``models/body/lbs.py``.

Each kernel's wrapper runs the kernel's plain PyTorch version for CPU
tensors and launches the kernel (or raises) for CUDA tensors.

This package never imports ``jax``.
"""

__version__ = "0.1.0"
