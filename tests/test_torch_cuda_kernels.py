"""``CudaKernel.device_functions`` on the CPU: the kernel names under
which ``utils/profiling.py`` gives each ``csrc/`` source its share of a
trace."""

import re

import pytest

from shapy_tpu_torch.utils.cuda_kernels import CSRC_DIR, CudaKernel

SOURCES = sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def _names(source: str) -> tuple:
    """``device_functions`` of a throwaway kernel of ``source``, leaving
    :attr:`CudaKernel.registry` as it was."""
    saved = dict(CudaKernel.registry)
    try:
        return CudaKernel(source, {}).device_functions()
    finally:
        CudaKernel.registry.clear()
        CudaKernel.registry.update(saved)


@pytest.mark.parametrize("source", SOURCES)
def test_device_functions_name_every_global(source):
    """One name per ``__global__`` function, whatever its launch bounds
    (K5-dgrad's take a constexpr call), and never a keyword."""
    names = _names(source)
    text = (CSRC_DIR / source).read_text()
    assert len(names) == len(re.findall(r"__global__", text))
    for name in names:
        assert not name.startswith("__")
        assert re.search(rf"\b{name}\s*\(", text)


def test_conv_names_the_wgmma_kernels():
    names = _names("conv.cu")
    assert {"dgrad_wgmma_kernel", "wgrad_wgmma_kernel",
            "wgrad_reduce_kernel", "conv_bf16_kernel"} <= set(names)
