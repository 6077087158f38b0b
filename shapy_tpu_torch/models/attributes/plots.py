"""Attribute-vs-beta scatter plots (port of
``shapy_tpu/models/attributes/plots.py``): one PNG a (attribute, beta)
pair of a regression database, ``<outdir>/<gender>/<attribute>_<beta>.png``,
on the synthetic database where no CAESAR files are present.

``matplotlib`` is imported when a plot is drawn; where it is not
installed, :func:`plot_ratings` raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import os

import numpy as np

from shapy_tpu_torch.models.attributes.constants import ATTRIBUTE_NAMES


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or an ``ImportError``
    that says who needs it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plot_ratings draws with matplotlib, which is "
                          "not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_ratings(ratings: np.ndarray, betas: np.ndarray, gender: str,
                 outdir: str) -> int:
    """One PNG a (attribute, beta) pair; returns the file count."""
    plt = _pyplot()
    names = ATTRIBUTE_NAMES[gender]
    os.makedirs(os.path.join(outdir, gender), exist_ok=True)
    count = 0
    for idx in range(ratings.shape[1]):
        aname = names[idx] if idx < len(names) else f"attr{idx}"
        for beta_idx in range(betas.shape[1]):
            plt.plot(ratings[:, idx], betas[:, beta_idx], ".")
            plt.savefig(
                os.path.join(outdir, gender, f"{aname}_{beta_idx}"))
            plt.close()
            count += 1
    return count


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Scatter-plot attribute ratings against betas")
    parser.add_argument("--db-folder", default="../data/dbs")
    parser.add_argument("--ds-name", default="caesar")
    parser.add_argument("--model-type", default="smplx")
    parser.add_argument("--num-betas", type=int, default=10)
    parser.add_argument("--outdir", default="../out/plots_attribute_betas")
    parser.add_argument("--genders", nargs="+",
                        default=["male", "female"])
    args = parser.parse_args()

    from shapy_tpu_torch.models.attributes.regression_data import (
        RegressionDataset,
    )

    for gender in args.genders:
        ds = RegressionDataset(
            ds_name=args.ds_name, ds_gender=gender,
            model_gender=gender, model_type=args.model_type,
            db_folder=args.db_folder,
        )
        if "train" not in ds.db:
            ds = RegressionDataset.synthetic(
                ds_gender=gender, model_gender=gender,
                model_type=args.model_type, num_betas=args.num_betas,
            )
        split = ds.db["train"]
        betas = np.asarray(split[ds.betas_key])[:, :args.num_betas]
        ratings = np.asarray(split["rating"])
        n = plot_ratings(ratings, betas, gender, args.outdir)
        print(f"{gender}: wrote {n} plots to {args.outdir}/{gender}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
