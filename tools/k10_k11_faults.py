"""Show that ``chip_smoke.py``'s K10 and K11 checks catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k10_k11_faults/<fault>/`` with one
part of the copy's ``csrc/conv.cu`` or ``csrc/max_pool.cu`` changed
(``chip_harness.run_faults``), and the copy runs phase 11's
``check_stem_kernel`` (K10's forward at batch 32 and 128 with the bias
and the ReLU, at 48 bare and at the odd sides 61 and 301: within K5's
bf16 limit of the plain version, two calls bit-equal, an image alone
bit-equal to itself in the batch) and ``check_pool_kernels`` (K11's
forward at batch 32 and its backward at 48 with planted all-zero and
tied windows, and at odd and tiny sides with 8- and 4-channel rows:
bit-equal in bf16 and f32, two calls bit-equal, one launch a call) on
seeded random inputs at the phase's shapes, with the timings reduced to
one call. Before the checks the copy fills and frees 8 GiB of device
memory with a large finite value, so that an output element the kernel
leaves unwritten holds it. The unplanted copy must pass and every planted
one fail, in the check that its kernel belongs to.

    python tools/k10_k11_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k10_k11_faults/<fault>.log``; the last line is a
JSON summary of return codes and verdicts. The copies run one at a time
(each holds several GiB of the card).
"""

from __future__ import annotations

import sys

from chip_harness import BUILD, run_faults

CONV = "shapy_tpu_torch/csrc/conv.cu"
POOL = "shapy_tpu_torch/csrc/max_pool.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # K10: the boxes from a 2-D map over the N H rows of all images, so
    # that an image's top padding rows are the previous image's last rows.
    "stem_top_pad_from_previous_image": [
        (CONV, "    const cuuint64_t dims[3] = {(cuuint64_t)3 * s.W, "
         "(cuuint64_t)s.H,\n                                (cuuint64_t)s.N};",
         "    const cuuint64_t dims[3] = {(cuuint64_t)3 * s.W, "
         "(cuuint64_t)s.H * s.N,\n                                1};"),
        (CONV, "                6 * wo0 - 9 - kStemShift, 2 * ho - 3, n);",
         "                6 * wo0 - 9 - kStemShift, n * s.H + 2 * ho - 3, "
         "0);")],
    # K10: each group's last pixel never stored (the output's TMA box a
    # pixel short of the group's 32).
    "stem_last_store_skipped": [
        (CONV, "    const cuuint32_t box[3] = {64, kStemGroup, 1};",
         "    const cuuint32_t box[3] = {64, kStemGroup - 1, 1};")],
    # K11: each tile's halo row of windows (the next tile's first) left
    # out: the tile's last odd pixel row loses what it receives from them.
    "pool_halo_window_dropped": [
        (POOL, "    if (i < s.Ho && j < s.Wo) {\n      unsigned rows = 0",
         "    if (i < s.Ho && j < s.Wo && a < p.th) {\n"
         "      unsigned rows = 0")],
    # K11: a tap in the padding taken as a candidate (its zero fill then
    # ties with the ReLU's zeros and takes their gradient).
    "pool_padded_tap_candidate": [
        (POOL, "        rows |= (unsigned)(2 * i - 1 + r >= 0 && 2 * i - 1 "
         "+ r < s.H) << r;\n        cols |= (unsigned)(2 * j - 1 + r >= 0 "
         "&& 2 * j - 1 + r < s.W) << r;\n",
         "        rows |= 1u << r;\n        cols |= 1u << r;\n")],
    # K11: ties going to the last maximum in row-major order (bf16).
    "pool_ties_to_last": [
        (POOL, "            __hgt2_mask(*reinterpret_cast<const "
         "__nv_bfloat162*>(&v[k]),",
         "            __hge2_mask(*reinterpret_cast<const "
         "__nv_bfloat162*>(&v[k]),")],
}

CAUGHT_BY = {"stem_top_pad_from_previous_image": "K10",
             "stem_last_store_skipped": "K10",
             "pool_halo_window_dropped": "K11",
             "pool_padded_tap_candidate": "K11",
             "pool_ties_to_last": "K11"}

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs.time_ms = lambda fn, iters=20, warmup=3, windows=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
poison = torch.full((8 << 30,), 0x7F, dtype=torch.uint8, device=dev)
del poison  # cached, and handed out again unwritten
cl = torch.channels_last
gen = torch.Generator().manual_seed(cs.SEED)


def randn(*shape, relu=False):
    t = torch.randn(shape, generator=gen)
    t = t.clamp_min(0) if relu else t
    return t.to(dev, torch.bfloat16).contiguous(memory_format=cl)


w = (randn(64, 3, 7, 7) / 147 ** 0.5).contiguous(memory_format=cl)
b = (torch.randn(64, generator=gen) * 0.3).to(dev, torch.bfloat16)
stem = (randn(cs.B, 3, cs.CROP, cs.CROP), w, b, None, True, 2)
stem_train = (randn(cs.TRAIN_B, 3, cs.CROP, cs.CROP), w)
x_served = randn(cs.B, 64, cs.CROP // 2, cs.CROP // 2, relu=True)
pools = [(randn(cs.TRAIN_B, 64, cs.CROP // 4, cs.CROP // 4),
          randn(cs.TRAIN_B, 64, cs.CROP // 2, cs.CROP // 2, relu=True))]
failed = False
for name, check in (("K10", lambda: cs.check_stem_kernel(stem, stem_train)),
                    ("K11", lambda: cs.check_pool_kernels(x_served, pools))):
    try:
        with torch.inference_mode():
            check()
        print(f"{name} checks passed")
    except RuntimeError as e:
        print(f"caught: {name}:", str(e)[:400])
        failed = True
sys.exit(1 if failed else 0)
"""

if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k10_k11_faults", FAULTS, RUN, sys.argv[1:],
                        caught_by=CAUGHT_BY, workers=1))
