"""K6 (mesh-mesh intersection), K7 (the repulsion loss, forward and
backward) and K9 (nearest-neighbour distances) at phase 9's shapes, and
phase 9's contact sequence, on two trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and measures, as device time
from ``chip_harness.trace`` (``torch.profiler`` traces of 5 calls between
spin kernels, checked), on ``chip_smoke.contact_bodies``' four SMPL-X body
pairs (20908 faces, 10475 vertices; the flagship's synthetic body model):

* ``k6_pair``, ``k6_batch4``: ``mesh_mesh_intersection`` of body A's
  triangles against body B's, 256 slots, for pair 0 and for the four
  pairs; ``k6_planes``: the plane route as phase 9 runs it, the chest,
  waist and hips quads (+-1 m, two triangles each) at K1's plane heights
  of every body A (``chip_smoke.plane_quads``), 1024 slots. Each:
  ``tri_tri.cu``'s time and kernels a call;
* ``k9_fscore``: ``point_fscore`` between pair 0's vertices (10475 x
  10475), ``nn_dists.cu``'s time and kernels a call (both directions);
  ``cdist_min``: ``torch.cdist`` + ``min`` both ways, the library
  yardstick;
* ``contact_wall_ms``: phase 9's sequence on the host clock (K6 body
  against body and plane against body, the contact pairs, K7's value and
  gradient, 24 F-scores between the bodies' vertices and between their
  20000-point regressed clouds), the median of 5 after 2 warm-ups;
* ``hashes``: of K6's ids and barycentrics (both routes) and of the 24
  F-scores, so that the trees' outputs compare bit for bit;
* ``k7_fwd``, ``k7_bwd``: K7 on phase 9's contact pairs of the four
  pairs (the two bodies' triangles side by side, 41816 faces a row), the
  forward ``repulsion_loss`` and the backward ``torch.autograd.grad`` of
  its loss with a (4,) cotangent, as phase 2 times them: ``ms``, the
  device time of a call (the union of its kernels' spans, library
  kernels and memsets included), ``kernels``, the device kernels a call,
  and ``by_name``, each kernel's ms and count a call; ``k7_loss_hash``
  and ``k7_grad_hash``, the loss's and the gradient's bytes.

The trees run in turns (``chip_harness.in_turns``, ``--rounds 2``: a b b
a), each run printing one JSON line; the last line gives each tree's
median of each number.

    python tools/perf_k6_k9_compare.py [--rounds N] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import sys

from chip_harness import in_turns

RUN = r"""
import hashlib, json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
from chip_harness import (PASSES, body_model, busy_ms, by_source, card,
                          smoke, trace)
from shapy_tpu_torch.eval import metrics
from shapy_tpu_torch.measure.measurements import BodyMeasurements
from shapy_tpu_torch.ops.repulsion import repulsion_loss
from shapy_tpu_torch.ops.tri_tri import mesh_mesh_intersection

dev = torch.device("cuda", 0)
cs = smoke()
model, anchors = body_model(dev)
bodies = cs.contact_bodies(model, dev)
a, b, va, vb = (bodies[k] for k in ("a", "b", "va", "vb"))
B, F = a.shape[:2]
a1, b1 = a[:1].contiguous(), b[:1].contiguous()
quads, _ = cs.plane_quads(BodyMeasurements(anchors, model.faces).to(dev), va)
rng = np.random.default_rng(5)
p2p = metrics.SparsePointRegressor(
    model.faces[rng.integers(0, F, size=20000)],
    rng.dirichlet(np.ones(3), size=20000), device=dev)
clouds = {"vertices": (va, vb), "p2p": (p2p.regress(va).contiguous(),
                                        p2p.regress(vb).contiguous())}
pa, pb = va[0].contiguous(), vb[0].contiguous()


def timed(fn, src):
    ms = by_source(trace(fn)).get(src, [])
    return {"ms": sum(ms) / PASSES, "kernels": len(ms) // PASSES}


def device_ms(fn):
    return sum(e - s for s, e, _ in trace(fn)) / 1e3 / PASSES


def fscores():
    return [metrics.point_fscore(p[k], q[k], t)["fscore"]
            for p, q in clouds.values() for k in range(B)
            for t in (0.005, 0.01, 0.02)]


def contact():
    with torch.no_grad():
        faces, _ = mesh_mesh_intersection(a, b, 256)
        mesh_mesh_intersection(quads, a, 1024)
    pairs = cs.contact_pairs(faces, 256, F)
    tris = torch.cat([a, b], dim=1).contiguous().requires_grad_()
    loss = repulsion_loss(tris, pairs)
    torch.autograd.grad(loss.sum(), tris)
    with torch.no_grad():
        fscores()
    torch.cuda.synchronize()


def call(fn):
    events = trace(fn)
    names = {}
    for start, stop, name in events:
        ms, n = names.get(name, (0.0, 0))
        names[name] = (ms + (stop - start) / 1e3 / PASSES, n + 1)
    return {"ms": busy_ms(events), "kernels": len(events) // PASSES,
            "by_name": {k: {"ms": v[0], "count": v[1] // PASSES}
                        for k, v in names.items()}}


out = {"card": card()}
with torch.no_grad():
    pairs = cs.contact_pairs(mesh_mesh_intersection(a, b, 256)[0], 256, F)
tris = torch.cat([a, b], dim=1).contiguous()
x = tris.clone().requires_grad_()
cot = torch.linspace(1.0, -0.5, B, device=dev)
loss = repulsion_loss(x, pairs)
out["k7_fwd"] = call(lambda: repulsion_loss(x, pairs))
out["k7_bwd"] = call(lambda: torch.autograd.grad(loss, x, cot,
                                                 retain_graph=True))
grad, = torch.autograd.grad(loss, x, cot, retain_graph=True)
out["k7_loss_hash"] = hashlib.sha256(
    loss.detach().cpu().numpy().tobytes()).hexdigest()[:16]
out["k7_grad_hash"] = hashlib.sha256(
    grad.cpu().numpy().tobytes()).hexdigest()[:16]
with torch.no_grad():
    out["k6_pair"] = timed(lambda: mesh_mesh_intersection(a1, b1, 256),
                           "tri_tri.cu")
    out["k6_batch4"] = timed(lambda: mesh_mesh_intersection(a, b, 256),
                             "tri_tri.cu")
    out["k6_planes"] = timed(lambda: mesh_mesh_intersection(quads, a, 1024),
                             "tri_tri.cu")
    out["k9_fscore"] = timed(lambda: metrics.point_fscore(pa, pb, 0.01),
                             "nn_dists.cu")
    out["cdist_min"] = device_ms(lambda: (torch.cdist(pa, pb).min(dim=1),
                                          torch.cdist(pb, pa).min(dim=1)))
    digest = hashlib.sha256()
    for t in (*mesh_mesh_intersection(a, b, 256),
              *mesh_mesh_intersection(quads, a, 1024),
              torch.stack(fscores())):
        digest.update(t.cpu().numpy().tobytes())
    out["hashes"] = digest.hexdigest()[:16]
for _ in range(2):
    contact()
walls = []
for _ in range(5):
    t0 = time.perf_counter()
    contact()
    walls.append((time.perf_counter() - t0) * 1e3)
out["contact_wall_ms"] = statistics.median(walls)
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    return in_turns(RUN, args.trees, args.rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
