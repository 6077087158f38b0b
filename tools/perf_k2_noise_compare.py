"""K2 on two trees, in turns on one card: its served crop, which the
channel-noise variant must leave as it was, and (where the tree has it)
the variant itself.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and ``git archive`` of its parent unpacked under ``chip_archive/``).
For each tree in turn a subprocess with that tree first on ``sys.path``
builds the tree's own K2 and, on ``flagship.synthetic_requests`` (480x360
uint8 images, seeded affines):

* ``served_ms``, ``served_hash``: one ``crop_normalize`` call at batch 32
  to bf16 256^2 crops, its device time from ``chip_harness.trace``
  (``torch.profiler`` traces of 5 calls between spin kernels, checked)
  and its output's bytes;
* ``train_ms``, ``train_hash``: the same at batch 48 without factors;
* ``noise_ms``, ``noise_hash``: at batch 48 with seeded (48, 3) factors in
  [0.6, 1.4], where the tree's ``crop_normalize`` takes them.

The trees run in turns (``chip_harness.in_turns``, ``--rounds 4``: a b b
a a b b a), each run printing one JSON line; the last line gives each
tree's median of each number. The lines also go to ``--out``.

    cd tools && python perf_k2_noise_compare.py [--rounds N] [--out PATH]
        TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

from chip_harness import REPO, Tee, in_turns

RUN = r"""
import hashlib, inspect, json, sys, torch
sys.path.insert(0, ".")
from chip_harness import busy_ms, card, trace
from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.flagship import synthetic_requests

dev = torch.device("cuda", 0)
out = {"card": card()}


def digest(t):
    return hashlib.sha256(
        t.view(torch.int16).contiguous().cpu().numpy().tobytes()).hexdigest()[
        :16]


for name, batch in (("served", 32), ("train", 48)):
    images, affines = (torch.from_numpy(a).to(dev) for a in
                       synthetic_requests(batch, 360, 480, 256, 0))

    def call(**kw):
        return crop_normalize(images, affines, 256,
                              out_dtype=torch.bfloat16, **kw)

    out[f"{name}_hash"] = digest(call())
    out[f"{name}_ms"] = busy_ms(trace(call))
    if name == "train" and "factors" in inspect.signature(
            crop_normalize).parameters:
        gen = torch.Generator(device=dev).manual_seed(3)
        factors = torch.rand((batch, 3), generator=gen, device=dev) * 0.8 + 0.6
        out["noise_hash"] = digest(call(factors=factors))
        out["noise_ms"] = busy_ms(trace(lambda: call(factors=factors)))
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--out", type=Path, default=REPO / "perf_runs" /
                        "pr23" / "k2_noise_compare.jsonl")
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    tee = Tee(args.out)
    with contextlib.redirect_stdout(tee):
        rc = in_turns(RUN, args.trees, args.rounds)
    tee.file.close()
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
