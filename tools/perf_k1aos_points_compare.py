"""K1-AoS's slice points (``measure_points``) and their backward
(``measure_points_backward``), and phase 6's scorer batch that runs them,
on two trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and, on the flagship's SMPL-X
(``chip_harness.body_model``: 20908 faces) at batch 32 (seeded bodies of
1.5 sigma, their triangles ``v[:, faces]``), in each slice mode:

* ``points_ms``, ``points_kernels``: the device time and device kernels
  (memsets included) of one ``measure_points`` call on the saves of a
  K1-AoS forward, from ``chip_harness.trace`` (``torch.profiler`` traces
  of 5 calls between spin kernels, checked); ``points_hash`` and
  ``valid_hash``, the points' and masks' bytes;
* ``backward_ms``, ``backward_kernels``: the same for one
  ``measure_points_backward`` call on those saves with a seeded (B, 3,
  6F) cotangent; ``grad_hash`` (the triangles' gradient: its per-face
  arithmetic is the parent's, so it hashes alike) and ``gh_hash`` (the
  plane heights' cotangent, summed in each tree's own order);
* ``surface_busy_ms``: the device time of phase 6's scorer batch, the
  triangle surface's forward under ``inference_mode`` (K1-AoS's walk and
  points); ``gradient_busy_ms`` and ``gradient_wall_ms``: phase 6's
  points-gradient batch (the forward, a loss on the circumferences and
  the squared slice points, the gradient in the vertices) as device time
  and as host wall over 20 batches after a synchronise.

The trees run in turns (``chip_harness.in_turns``, ``--rounds 4``: a b b
a a b b a), each run printing one JSON line; the last line gives each
tree's median of each number. The lines also go to ``--out``.

    python tools/perf_k1aos_points_compare.py [--rounds N] [--out PATH]
        TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

from chip_harness import REPO, in_turns

RUN = r"""
import hashlib, json, sys, time, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, body_model, busy_ms, card, trace
from shapy_tpu_torch.measure import measurements as M

dev = torch.device("cuda", 0)
model, anchors = body_model(dev)
gen = torch.Generator().manual_seed(12)
B = 32
betas = torch.randn((B, model.num_betas), generator=gen) * 1.5
v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
faces = model.faces_tensor.long()
tri = v[:, faces].contiguous()
F = faces.shape[0]
g_points = torch.randn((B, 3, 6 * F), generator=gen).to(dev)
identity = torch.arange(3 * F, dtype=torch.int32, device=dev).view(F, 3)
out = {"card": card()}


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[
        :16]


def routes(mode, saved):
    # Each tree's kernel route on the forward's saves.
    if hasattr(M, "points_plan"):
        return (lambda: M.measure_points(saved, mode),
                lambda: M.measure_points_backward(saved, g_points, (F,) * 3,
                                                  mode))
    verts, hits, codes, stats, plane_h = saved
    exact = int(mode == "exact")

    def fwd():
        points = torch.empty((B, 3, 6 * F), device=dev)
        valid = torch.empty((B, 3, F if exact else 2 * F), dtype=torch.bool,
                            device=dev)
        M.MEASURE_KERNEL.launch("measure_points", [
            verts, identity, hits, codes, stats, plane_h, points, valid, B,
            3 * F, F, codes.shape[2], exact])
        return points, valid

    def bwd():
        grad = torch.empty_like(verts)
        g_h = torch.empty((B, 3), device=dev)
        M.MEASURE_KERNEL.launch("measure_points_backward", [
            verts, identity, plane_h, g_points, grad,
            torch.empty((B, 3, F), device=dev), g_h, B, 3 * F, F, F, F, F,
            exact])
        return grad, g_h

    return fwd, bwd


def kernel_row(fn):
    events = trace(fn)
    return (sum(b - a for a, b, _ in events) / 1e3 / PASSES,
            len(events) // PASSES)


for mode in ("reference", "exact"):
    meas = M.BodyMeasurements(anchors, model.faces, 256,
                              slice_mode=mode).to(dev)
    x = tri.clone().requires_grad_()
    got = meas(x)["measurements"]
    saved = got["mass"]["tensor"]._base.grad_fn.saved_tensors
    fwd, bwd = routes(mode, saved)
    points, valid = fwd()
    grad, g_h = bwd()
    row = {"points_hash": digest(points), "valid_hash": digest(valid),
           "grad_hash": digest(grad), "gh_hash": digest(g_h)}
    row["points_ms"], row["points_kernels"] = kernel_row(fwd)
    row["backward_ms"], row["backward_kernels"] = kernel_row(bwd)

    def surface():
        with torch.inference_mode():
            return meas(tri)

    xv = v.clone().requires_grad_()

    def gradient():
        m = meas(xv[:, faces])["measurements"]
        loss = sum(m[k]["tensor"].sum() + m[k]["points"].square().sum()
                   for k in ("chest", "waist", "hips"))
        return torch.autograd.grad(loss, xv)[0]

    row["surface_busy_ms"] = busy_ms(trace(surface))
    row["gradient_busy_ms"] = busy_ms(trace(gradient))
    for _ in range(3):
        gradient()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        gradient()
    torch.cuda.synchronize()
    row["gradient_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    out[mode] = row
    del x, got, saved
print(json.dumps(out))
"""


class _Tee:
    """Standard output, copied to a file."""

    def __init__(self, path: Path):
        self.file = path.open("w")

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        return self.file.write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()
        self.file.flush()


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--out", type=Path, default=REPO / "perf_runs" /
                        "pr21" / "k1aos_points_compare.jsonl")
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    tee = _Tee(args.out)
    with contextlib.redirect_stdout(tee):
        rc = in_turns(RUN, args.trees, args.rounds)
    tee.file.close()
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
