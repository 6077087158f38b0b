"""Where K5-dgrad and K5-wgrad's wgmma kernels spend their time.

Needs one CUDA card. Builds copies of ``shapy_tpu_torch/csrc/conv.cu``
with one part of a kernel's work switched off (the MMA, an operand's
loads, the output's stores) and times each copy's K5-dgrad and K5-wgrad
at the backbone's heavy shapes at batch 48, in bf16, beside cuDNN's
``aten.convolution_backward`` on the same inputs. A switched-off load
also takes its bytes out of the stage's mbarrier count, so every copy
runs its ring to the end; the copies compute wrong values and are only
timed. The time a part saves bounds what making it free could gain.

    python tools/perf_k5_backward_ablate.py

The copies are written to ``shapy_tpu_torch/_build/k5_ablate/`` (ignored
by git); the tree is never edited. Prints one line per copy and kernel:
us per call at each shape.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "shapy_tpu_torch" / "_build" / "k5_ablate"
# (Cin, Cout, k, stride, input side): the heaviest of a train step.
SHAPES = [(48, 48, 3, 1, 64), (96, 96, 3, 1, 32), (192, 192, 3, 1, 16),
          (384, 384, 3, 1, 8), (2048, 2048, 1, 1, 8), (48, 96, 3, 2, 64),
          (256, 48, 3, 1, 64)]
BATCH = 48

# K5-dgrad's parts (in implicit_gemm, which K5-conv shares: the A loads
# and the byte count are switched off for both, only K5-dgrad is timed).
D_MMA = ("            Wgmma<BN, 0, 1>::mma(acc, sw128_desc(a + kk * 32, 16, "
         "1024),\n                                 sw128_desc(b + kk * 2048, "
         "BK * 128, 1024));\n")
D_TX = "(uint32_t)(64 * P.box_w * P.box_h * P.box_n * 2 + kStageB);"
D_A = ("        tma_load_4d(As + st * kStageA, &amap, &full[st], k0,\n"
       "                    P.astride * d.j0 + dw, P.astride * d.i0 + dh, "
       "d.n0);\n")
D_B = ("            tma_load_3d(b + j * BK * 128, &wmap, &full[st], d.ci0 + "
       "64 * j,\n                        rc, k0);\n")
D_STORE = "          *reinterpret_cast<uint4*>(out + idx) = u;\n"
# K5-wgrad's parts.
W_MMA = ("          Wgmma<BN, 1, 1>::mma(acc, sw128_desc(a + kk * 2048, kBox, "
         "1024),\n                               sw128_desc(b + kk * 2048, "
         "kBox, 1024));\n")
W_TX = "(uint32_t)((kMask ? 0 : kStageB) + (kXTma ? kStageA : 0));"
W_DY = ("              tma_load_2d(b + j * kBox, &dymap, &full[st], co0 + 64 "
        "* j, g0);\n")
W_GATHER = ("            cp_async16(a + a_off + sw128(row, chunk & 7), x + "
            "(ok ? src : 0),\n                       ok);\n")
W_STORE = ("            dst[(size_t)co * P.K + kr_h] = acc[4 * j + 2 * h];\n"
           "            dst[(size_t)(co + 1) * P.K + kr_h] = acc[4 * j + 2 * h "
           "+ 1];\n")

# copy -> [(text, replacement)]: each text must occur once in conv.cu.
VARIANTS = {
    "base": [],
    "dgrad_no_mma": [(D_MMA, "")],
    "dgrad_no_dy_loads": [(D_A, ""), (D_TX, "(uint32_t)kStageB;")],
    "dgrad_no_weight_loads": [
        (D_B, ""),
        (D_TX, "(uint32_t)(64 * P.box_w * P.box_h * P.box_n * 2);")],
    "dgrad_no_loads": [(D_A, ""), (D_B, ""), (D_TX, "0u;")],
    "dgrad_no_store": [(D_STORE, "")],
    "wgrad_no_mma": [(W_MMA, "")],
    "wgrad_no_dy_loads": [(W_DY, ""),
                          (W_TX, "(uint32_t)(kXTma ? kStageA : 0);")],
    "wgrad_no_x_gather": [(W_GATHER, "")],
    "wgrad_no_store": [(W_STORE, "")],
}


def variant_source(name: str, text: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: its part is not in conv.cu once")
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch

    import chip_smoke as cs
    from shapy_tpu_torch.models.backbones import layers
    from shapy_tpu_torch.utils.cuda_kernels import CSRC_DIR, CudaKernel

    src = (CSRC_DIR / "conv.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for name in VARIANTS:
        path = OUT / f"conv_{name}.cu"
        path.write_text(variant_source(name, src))
        kernels[name] = CudaKernel(str(path),
                                   dict(layers.CONV_KERNEL.functions))
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda k: k.build(), kernels.values()))
    print(cs.gpu_line(), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    cl = torch.channels_last
    cases = []
    for cin, cout, k, s, side in SHAPES:
        out = (side + 2 * (k // 2) - k) // s + 1
        x = torch.randn(BATCH, cin, side, side, generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
        w = (torch.randn(cout, cin, k, k, generator=gen) * 0.05).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
        dy = torch.randn(BATCH, cout, out, out, generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
        cases.append(((cin, cout, k, s, side), dy, x, w, s))

    def row(label, fn):
        times = [f"{key}: {cs.time_ms(lambda: fn(dy, x, w, s)) * 1e3:.1f}"
                 for key, dy, x, w, s in cases]
        print(f"{label:28s} " + " | ".join(times), flush=True)

    saved = layers.CONV_KERNEL
    try:
        for kind in ("dgrad", "wgrad"):
            for name, kern in kernels.items():
                if name != "base" and not name.startswith(kind):
                    continue
                layers.CONV_KERNEL = kern
                if kind == "dgrad":
                    row(f"{name} (dgrad us)", lambda dy, x, w, s:
                        layers._conv2d_dgrad_cuda(dy, w, x.shape, s))
                else:
                    row(f"{name} (wgrad us)", lambda dy, x, w, s:
                        layers._conv2d_wgrad_cuda(x, dy, None, w.shape, s,
                                                  False))
            layers.CONV_KERNEL = saved
            mask = (True, False, False) if kind == "dgrad" else (
                False, True, False)
            row(f"cuDNN ({kind} us)", lambda dy, x, w, s: cs._conv_library(
                dy, x, w, s, mask))
    finally:
        layers.CONV_KERNEL = saved
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
