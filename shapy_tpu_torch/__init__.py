"""shapy_tpu_torch — the PyTorch/CUDA port of ``shapy_tpu``.

The JAX package ``shapy_tpu`` is the reference; this package mirrors its
module paths one to one and keeps its public layouts (NHWC images,
``(B, V, 3)`` vertices, ``(B, J, 3, 3)`` rotations) so the two can be
compared on the same numpy inputs.

Plain tensor code is PyTorch. The ops that the JAX package shaped by hand
for the TPU are CUDA kernels written for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``:

  * K1 measure  — ``measure/measurements.py`` (plane slice, hull, mass,
    height in one launch; K1-AoS runs it on (B, F, 3, 3) triangles and
    writes their slice points),
  * K2 ingest   — ``data/crop.py`` (uint8 decode, bilinear crop,
    ImageNet normalisation, cast),
  * K3 skinning — ``models/body/lbs.py`` (forward and backward),
  * K3-chain    — ``core/kinematics.py`` (the kinematic chain, forward
    and backward),
  * K4 train-mode BatchNorm — ``models/backbones/layers.py`` (moments,
    running-stat EMA, normalise, fused backward; bf16 / f32),
  * K8a P2P-20k point error — ``eval/metrics.py`` (sparse point
    regression of both meshes, translation alignment, distances),
  * K8b aligned point error — ``eval/metrics.py`` (none / root /
    translation / scale / Procrustes alignment, then the error).

Each kernel's wrapper runs the kernel's plain PyTorch version for CPU
tensors and launches the kernel (or raises) for CUDA tensors; a kernel
with a backward is a ``torch.autograd.Function``. Entry
points run on the card unless the caller asks for the CPU.

This package never imports ``jax``, ``yaml`` or ``shapy_tpu``.
"""

__version__ = "0.1.0"
