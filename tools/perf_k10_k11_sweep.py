"""K10's forward and K11's backward at the ResNet's shapes, in variants of
their sources and plans, on one card: what holds each kernel back.

Needs one CUDA card. Each variant is a copy of this repository's port
under ``shapy_tpu_torch/_build/k10_k11_sweep/<variant>/`` whose
``csrc/conv.cu`` or ``csrc/max_pool.cu`` has some text replaced
(``chip_harness.planted_copy``). A subprocess per variant builds the copy
and times, as device time from ``chip_harness.trace`` (``torch.profiler``
traces of 5 calls between spin kernels, checked): K10's forward
(``conv2d_act`` on a 7x7 / stride-2 stem, bf16 256x256 crops) at batch
32 and 128 with the folded BN's bias and the ReLU and at 48 bare, and
K11's backward at a ResNet train step's shape (48 x 64 x 128^2 bf16,
small integers after a ReLU: most windows tie) on its plan. Each output's hash is
printed (K10's equals the parent kernel's where the sums are the same),
and whether K11's is bit-equal to ``max_pool2d_backward_plain`` (variants
that leave a part out time the rest, nothing else).

    python tools/perf_k10_k11_sweep.py [--variants NAME ...]

K10's variants: ``as_is``; ``stem_stages_3`` (a 3-deep ring a warp:
two blocks an SM, on 264); ``stem_grid_264`` (264 blocks, two an SM);
``stem_warps_8`` (8 warps a block); ``stem_scalar_epilogue`` (the
epilogue element by element in f32, as the parent's); ``stem_no_mma``,
``stem_no_epilogue``, ``stem_no_store``, ``stem_no_shift`` (the
products, the epilogue's roundings, the output's TMA store, the landed
box's move into alignment left out, by a condition false at run
time). K11's: ``pool_tile_4``, ``pool_tile_16`` (4 x 4 or 16 x 16
windows a block), ``pool_slice_64`` (64 bytes of channels a pixel: 32
bf16 channels), through the plan's constants in ``layers.py``;
``pool_no_windows`` (no window's maximum found), ``pool_no_pixels`` (no
pixel gathered or stored), ``pool_no_store`` (gathered, not stored).
Prints a JSON line a
variant, with each kernel's registers from the copy's build.
"""

from __future__ import annotations

import argparse
import shutil
import sys

from chip_harness import BUILD, REPO, planted_copy, run_script

OUT = BUILD / "k10_k11_sweep"
CONV = "shapy_tpu_torch/csrc/conv.cu"
POOL = "shapy_tpu_torch/csrc/max_pool.cu"

_EPILOGUE = """          __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          if (bias) v = __hadd2(v, bb[nt]);
          if (relu) v = relu2(v);
"""
_SCALAR_EPILOGUE = """          float f[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            f[u] = rnd<bf16>(acc[mt][nt][2 * half + u]);
            if (bias) f[u] = rnd<bf16>(f[u] + to_f(bias[nt * 8 + 2 * t + u]));
            if (relu) f[u] = f[u] < 0.f ? 0.f : f[u];
          }
          __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
"""


def _stem_const(name, old, new):
    return (CONV, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


LAYERS = "shapy_tpu_torch/models/backbones/layers.py"
_GRID = (LAYERS, "_STEM_BLOCKS = 396", "_STEM_BLOCKS = 264")


def _pool_plan(tile, slice_bytes):
    return (LAYERS, "_POOL_TILE, _POOL_SLICE_BYTES = 8, 128",
            f"_POOL_TILE, _POOL_SLICE_BYTES = {tile}, {slice_bytes}")


# name -> [(file, text, replacement)]
VARIANTS = {
    "as_is": [],
    "stem_stages_3": [_stem_const("kStemStages", 2, 3),
                      _stem_const("kStemWarpBytes", "11 * 1024",
                                  "14 * 1024"), _GRID],
    "stem_grid_264": [_GRID],
    "stem_warps_8": [_stem_const("kStemWarps", 4, 8)],
    "stem_scalar_epilogue": [(CONV, _EPILOGUE, _SCALAR_EPILOGUE)],
    "stem_no_mma": [(CONV, "        for (int nt = 0; nt < 8; ++nt) "
                     "mma_bf16(acc[mt][nt], a[mt], b[nt]);\n    }\n"
                     "    // The",
                     "        for (int nt = 0; nt < 8; ++nt) if (s.N < 0) "
                     "mma_bf16(acc[mt][nt], a[mt], b[nt]);\n    }\n"
                     "    // The")],
    "stem_no_epilogue": [(CONV, _EPILOGUE, """          __nv_bfloat162 v;
          *reinterpret_cast<float*>(&v) = acc[mt][nt][2 * half] +
                                          acc[mt][nt][2 * half + 1];
""")],
    "stem_no_store": [(CONV, "    if (lane == 0) tma_store_3d(&ymap, out, 0, "
                       "wo0, n * s.Ho + ho);\n",
                       "    if (lane == 0 && s.N < 0) tma_store_3d(&ymap, "
                       "out, 0, wo0, n * s.Ho + ho);\n")],
    "stem_no_shift": [(CONV, "      for (int i = 0; i < kPer; ++i) {\n"
                       "        const int e = lane + 32 * i;\n"
                       "        if (e >= kStemRows * kOut) continue;\n"
                       "        const int r = e / kOut;\n",
                       "      for (int i = 0; i < kPer * (s.N < 0); ++i) {\n"
                       "        const int e = lane + 32 * i;\n"
                       "        if (e >= kStemRows * kOut) continue;\n"
                       "        const int r = e / kOut;\n")],
    "pool_tile_4": [_pool_plan(4, 128)],
    "pool_tile_16": [_pool_plan(16, 128)],
    "pool_slice_64": [_pool_plan(8, 64)],
    "pool_no_windows": [(POOL, "  for (int e = tid; e < wins * chunks; e += "
                         "kThreads) {\n    const int q = e & (chunks - 1), "
                         "win = e >> cshift;\n    const int a = win / ww,",
                         "  for (int e = tid; e < wins * chunks * (s.N < 0); "
                         "e += kThreads) {\n    const int q = e & (chunks - "
                         "1), win = e >> cshift;\n    const int a = win / ww,"
                         )],
    "pool_no_pixels": [(POOL, "  for (int e = tid; e < p.th * p.tw * chunks; "
                        "e += kThreads) {\n",
                        "  for (int e = tid; e < p.th * p.tw * chunks * (s.N "
                        "< 0); e += kThreads) {\n")],
    "pool_no_store": [(POOL, "      store16(out + ((size_t)dh * s.W + dw) * "
                       "s.C, acc);\n",
                       "      if (s.N < 0) store16(out + ((size_t)dh * s.W "
                       "+ dw) * s.C, acc);\n")],
}

RUN = r"""
import hashlib, json, re, sys, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, by_source, trace
from shapy_tpu_torch.models.backbones import layers
dev = torch.device("cuda", 0)
out = {"variant": sys.argv[1]}
cl = torch.channels_last


def ms(fn, src):
    return sum(by_source(trace(fn)).get(src, [])) / PASSES


def digest(t):
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


gen = torch.Generator().manual_seed(7)
w = (torch.randn((64, 3, 7, 7), generator=gen) / 147 ** 0.5).to(
    dev, torch.bfloat16).contiguous(memory_format=cl)
b = (torch.randn(64, generator=gen) * 0.3).to(dev, torch.bfloat16)
with torch.inference_mode():
    for n, full in ((32, True), (128, True), (48, False)):
        x = torch.randn((n, 3, 256, 256), generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
        bb = b if full else None
        fn = lambda: layers.conv2d_act(x, w, bb, None, full, 2)  # noqa: E731
        out[f"k10_b{n}"] = ms(fn, "conv.cu")
        out[f"k10_b{n}_hash"] = digest(fn())
    x = torch.randint(-2, 3, (48, 64, 128, 128), generator=gen).float()
    x = x.clamp_min(0).to(dev, torch.bfloat16).contiguous(memory_format=cl)
    dy = torch.randn((48, 64, 64, 64), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    want = layers.max_pool2d_backward_plain(dy, x)
    fn = lambda: layers._max_pool2d_backward_cuda(dy, x)  # noqa: E731
    out["k11b_b48"] = ms(fn, "max_pool.cu")
    out["k11b_b48_bit_equal"] = torch.equal(fn(), want)
out["registers"] = {}
for kernel in (layers.CONV_KERNEL, layers.POOL_KERNEL):
    name = None
    for line in kernel.build_log.splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        name = found.group(1) if found else name
        found = re.search(r"Used (\d+) registers", line)
        if found and name and ("stem7_kernel" in name
                               or "max_pool_backward" in name):
            out["registers"][name[:48]] = int(found.group(1))
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = parser.parse_args(argv)
    failed = 0
    for name in args.variants:
        dst = planted_copy(OUT / name, VARIANTS[name], root=REPO)
        proc = run_script(RUN, dst, (name,), timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{name}: rc {proc.returncode}\n{proc.stderr[-2000:]}")
            failed += 1
        else:
            print(lines[-1], flush=True)
        shutil.rmtree(dst)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
