"""K4's forward and backward in each regime at every BN shape of a step.

Needs one CUDA card. For each BN shape of HRNet-W48's train step at batch
48 (shapes and counts recorded from one forward of the model at batch 1,
on the CPU), in bf16 and f32, times K4's forward (``_bn_forward_cuda``) and
backward (``_bn_backward_cuda``) forced into the three-launch regime and
into the one-launch cluster regime with clusters of 8 and of 16 blocks,
beside ``F.batch_norm(training=True)`` and its autograd backward, each
call alone in a CUDA-event window; checks that the regimes agree within
K4's limits; and prints which regime ``_bn_plan`` picks and which was
fastest, for each pass. The regime threshold in ``layers.py``
(``_BN_CLUSTER_ROWS``, ``_BN_CLUSTER_BLOCKS``), which both passes share,
is read off this table.

    python tools/perf_k4_regimes.py

Prints one JSON line per shape and dtype, then a summary line.
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def step_shapes() -> collections.Counter:
    """(C, H, W) -> count of the BNs of one train-mode forward."""
    import torch

    from shapy_tpu_torch.models.backbones import layers
    from shapy_tpu_torch.models.backbones.hrnet import HRNet

    shapes = collections.Counter()
    bn_fn = layers.batch_norm_train

    def bn(x, *args, **kwargs):
        shapes[tuple(x.shape[1:])] += 1
        return bn_fn(x, *args, **kwargs)

    layers.batch_norm_train = bn
    try:
        with torch.no_grad():
            HRNet().train()(torch.randn(1, 3, 256, 256))
    finally:
        layers.batch_norm_train = bn_fn
    return shapes


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from shapy_tpu_torch.models.backbones import layers

    if not torch.cuda.is_available():
        print("perf_k4_regimes: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cl = torch.channels_last
    gen = torch.Generator().manual_seed(0)
    rows, picked_best, fwd_picked_best = [], 0, 0
    for (c, h, w), count in sorted(step_shapes().items(),
                                   key=lambda kv: -kv[0][1]):
        for dtype in (torch.bfloat16, torch.float32):
            shape = (48, c, h, w)
            x = (torch.randn(shape, generator=gen) * 2 + 0.3).to(
                dev, dtype).contiguous(memory_format=cl)
            dy = torch.randn(shape, generator=gen).to(dev, dtype).contiguous(
                memory_format=cl)
            g = (torch.rand(c, generator=gen) + 0.5).to(dev)
            mean, var = layers._moments_plain(x)
            inv = torch.rsqrt(var + layers.BN_EPS)
            R = 48 * h * w
            split = layers._bn_plan_regime(R, c, False)
            cluster = layers._bn_plan_regime(R, c, True)
            plans = {"split": split}
            for blocks in (8, 16):
                plans[f"cluster{blocks}"] = cluster._replace(
                    tiles=blocks, rows=-(-R // blocks))
            want = layers.batch_norm_train_backward_plain(dy, x, g, mean, inv)
            b = torch.zeros_like(g)
            y_p, mean_p, var_p = layers.batch_norm_train_plain(x, g, b)
            want_f = (y_p, mean_p, torch.rsqrt(var_p + layers.BN_EPS))
            times, fwd_times = {}, {}
            for name, plan in plans.items():
                got = layers._bn_backward_cuda(dy, x, g, mean, inv, plan)
                over = max(cs._k4_limits(got, want).values())
                got = layers._bn_forward_cuda(x, g, b, None, None,
                                              layers.BN_EPS, 0.1, plan)
                over = max(over, *cs._k4_forward_limits(got,
                                                        want_f).values())
                cs.check(over <= 1.0, f"{shape} {dtype} {name}: {over:.3f} "
                                      "of K4's limit")
                times[name] = cs.time_ms(lambda: layers._bn_backward_cuda(
                    dy, x, g, mean, inv, plan))
                fwd_times[name] = cs.time_ms(lambda: layers._bn_forward_cuda(
                    x, g, b, None, None, layers.BN_EPS, 0.1, plan))
            xl, gl = x.clone().requires_grad_(), g.clone().requires_grad_()
            bl = torch.zeros_like(gl).requires_grad_()
            yl = F.batch_norm(xl, None, None, gl, bl, True, 0.1,
                              layers.BN_EPS)
            times["F.batch_norm"] = cs.time_ms(lambda: torch.autograd.grad(
                yl, (xl, gl, bl), dy, retain_graph=True))
            fwd_times["F.batch_norm"] = cs.time_ms(lambda: F.batch_norm(
                x, None, None, g, b, True, 0.1, layers.BN_EPS))
            pick, fwd_pick = (
                "split" if not p.fused else f"cluster{p.tiles}"
                for p in (layers._bn_plan(R, c), layers._bn_plan(R, c, True)))
            best = min((k for k in plans), key=times.get)
            fwd_best = min((k for k in plans), key=fwd_times.get)
            picked_best += pick == best
            fwd_picked_best += fwd_pick == fwd_best
            row = {"shape": list(shape), "dtype": str(dtype)[6:],
                   "count": count, "ms": times, "fwd_ms": fwd_times,
                   "planned": pick, "fastest": best,
                   "fwd_planned": fwd_pick, "fwd_fastest": fwd_best}
            rows.append(row)
            print(json.dumps(row), flush=True)
    total = {key: {k: sum(r[key][r[planned] if k == "planned" else k]
                          * r["count"] for r in rows
                          if r["dtype"] == "bfloat16")
                   for k in ("split", "cluster8", "cluster16", "planned",
                             "F.batch_norm")}
             for key, planned in (("ms", "planned"),
                                  ("fwd_ms", "fwd_planned"))}
    print(json.dumps({"gpu": cs.gpu_line(), "planned_is_fastest": picked_best,
                      "fwd_planned_is_fastest": fwd_picked_best,
                      "cases": len(rows),
                      "bf16_step_sum_ms": total["ms"],
                      "fwd_bf16_step_sum_ms": total["fwd_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
