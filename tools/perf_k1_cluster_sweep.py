"""K1's forward at every cluster size, on the paths that run it.

Needs one CUDA card. Builds the flagship's SMPL-X as ``chip_smoke.py``
does and times one K1 forward (``chip_smoke.device_ms``: the device time
of its kernels) with ``measurements.measure_plan`` forced to clusters of
1, 2, 3, 4, 6, 8, 12 and 16 CTAs, then with the plan itself, on: all
faces at batch 1 (the fit) and 48 (a train step) in both slice modes, the
candidate subsets at batch 32 (a served request) and the scorer's
triangles at batch 32 in both modes (K1-AoS's walk). Prints one line per
case and the whole table as JSON last.

    python tools/perf_k1_cluster_sweep.py
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CLUSTERS = (1, 2, 3, 4, 6, 8, 12, 16)


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from shapy_tpu_torch.flagship import build_flagship, spread_init_
    from shapy_tpu_torch.measure import measurements as M

    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                          seed=cs.SEED)
    spread_init_(base, seed=cs.SEED, beta_scale=0.25)
    model = copy.deepcopy(base.model).to(dev)
    served = copy.deepcopy(base.body_measurements).to(dev)
    anchors, F = served.anchors, served.faces.shape[0]
    gen = torch.Generator().manual_seed(cs.SEED + 10)
    planned = M.measure_plan
    table = {}
    for batch in (1, cs.TRAIN_B, cs.B):
        betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
        v = model.forward_shape(betas.to(dev))["v_shaped"].detach()
        v = v.contiguous()
        tri = v[:, model.faces_tensor.long()].contiguous()
        cases = []
        for mode in ("reference", "exact"):
            meas = M.BodyMeasurements(anchors, model.faces, 256,
                                      slice_mode=mode).to(dev)
            if batch != cs.B:
                cases.append((f"{mode}_all_b{batch}",
                              lambda meas=meas: meas.measure(v, False)))
                continue
            if mode == "reference":
                cases.append((f"subsets_b{batch}",
                              lambda: served.measure(v, True)))
            walk = meas._triangle_walk(F, dev, tuple(anchors.ordered()),
                                       (F,) * 3)
            cases.append((f"{mode}_aos_walk_b{batch}",
                          lambda meas=meas, walk=walk: M._MeasureKernel.apply(
                              tri.view(batch, 3 * F, 3), meas, walk, False)))
        for name, fn in cases:
            row = {}
            try:
                for k in CLUSTERS:
                    M.measure_plan = lambda counts, F_, B_, k=k: M.MeasurePlan(
                        k, tuple(-(-n // k) for n in counts), -(-F_ // k))
                    row[str(k)] = cs.device_ms(fn)
            finally:
                M.measure_plan = planned
            row["plan"] = cs.device_ms(fn)
            table[name] = row
            print(name, json.dumps({k: round(t, 4) for k, t in row.items()}),
                  flush=True)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
