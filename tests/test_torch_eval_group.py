"""The grouped point errors (K8b's one launch an eval batch), the K8
kernels' plans and the replays of their reduction order, on the CPU.

On the CPU :func:`aligned_point_errors` runs the plain version for every
alignment of every pair, so the evaluator's numbers must stay bit for bit
what the nine single :class:`PointError` calls give, and match the JAX
package's ``PointError`` (atol 1e-5 m, as ``tests/test_torch_eval.py``).
The plans (``align_plan``, ``regress_plan``) split a body's points into
runs of CTAs from the shape alone; ``kernel_order_sum`` replays the
kernels' fixed reduction order, which the card's checks hold the kernels'
totals to bit for bit. The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.eval import metrics as jm
from shapy_tpu_torch.eval import evaluator as tev
from shapy_tpu_torch.eval import metrics as tm

torch.set_num_threads(2)
REFERENCE_CFG = {"evaluation": {"body": {
    "v2v": ("procrustes", "scale", "translation"),
    "v2v_t": ("scale", "translation"),
    "mpjpe": {"alignments": ("root", "procrustes")},
}}}
ALIGNS = ("none", "root", "translation", "scale", "procrustes")


def _cloud(rng, B, P):
    scales = np.asarray([1.0, 0.6, 0.3])  # distinct singular values
    return (rng.normal(size=(B, P, 3)) * scales).astype(np.float32)


def _pairs(rng, B, V=70, J=9):
    """The evaluator's four point-set pairs at a small size: v_shaped,
    posed vertices, joints (with a confidence channel on the GT), J14."""
    est = {k: torch.from_numpy(_cloud(rng, B, n)) for k, n in
           (("v_shaped", V), ("vertices", V), ("joints", J), ("j14", 14))}
    gt = {k: v + torch.from_numpy(0.02 * _cloud(rng, B, v.shape[1]) + 0.3)
          for k, v in est.items()}
    return est, gt


def _evaluator_jobs(ev, est, gt):
    """(PointError, est, gt) of the evaluator's nine point-error calls."""
    jobs = []
    for pes, key in ((ev.v2v_t_alignments, "v_shaped"),
                     (ev.v2v_alignments, "vertices"),
                     (ev.alignments, "joints"),
                     (ev.mpjpe14_alignments, "j14")):
        jobs += [(pe, est[key], gt[key]) for pe in pes.values()]
    return jobs


@pytest.mark.parametrize("plain", [False, True])
def test_grouped_errors_equal_the_single_calls_bitwise(plain):
    """The evaluator's group (nine alignments of four pairs, the mpjpe14
    root on the hips) against each PointError call alone, bit for bit."""
    rng = np.random.default_rng(0)
    est, gt = _pairs(rng, B=4)
    ev = tev.build_evaluator(REFERENCE_CFG, device="cpu")
    jobs = _evaluator_jobs(ev, est, gt)
    assert len(jobs) == 9
    got = tev._point_error_means([(i, pe, e, g) for i, (pe, e, g)
                                  in enumerate(jobs)], plain)
    for i, (pe, e, g) in enumerate(jobs):
        single = (pe.plain if plain else pe)(e, g)
        assert torch.equal(got[i], single.mean(dim=-1)), pe.name
    groups = tm.aligned_point_errors(
        [(est["joints"], gt["joints"], ("root", "procrustes"), (0,)),
         (est["j14"], gt["j14"], ("root", "procrustes"), (2, 3))], plain)
    for out, key, root in ((groups[0], "joints", (0,)),
                           (groups[1], "j14", (2, 3))):
        for name in ("root", "procrustes"):
            want = tm.PointError(name, root=root)(est[key], gt[key])
            assert torch.equal(out[name], want)


@pytest.mark.parametrize("names,root", [
    (ALIGNS, (1, 4)), (("scale", "translation"), None),
    (("procrustes", "scale", "translation"), None),
    (("root", "procrustes"), (2, 3))])
def test_grouped_errors_match_jax(names, root):
    rng = np.random.default_rng(1)
    x, y = _cloud(rng, 3, 40), _cloud(rng, 3, 40)
    y = y * 0.1 + x
    got = tm.aligned_point_errors(
        [(torch.from_numpy(y), torch.from_numpy(x), names, root)])[0]
    for name in names:
        want = jm.PointError(name, root=root)(jnp.asarray(y), jnp.asarray(x))
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                   atol=1e-5, err_msg=name)


def test_any_alignment_set_is_grouped_into_pairs():
    """Two root sets and 'none' / 'no' (one mode) on the same pair: each
    metric still as its single call, the jobs packed into as few pairs as
    the kernel takes (one root set and each mode once a pair)."""
    rng = np.random.default_rng(2)
    est, gt = _pairs(rng, B=3)
    alignments = {"root": tm.PointError("root", (0,)),
                  "hips": tm.PointError("root", (1, 2)),
                  "none": tm.PointError("none"), "no": tm.PointError("no"),
                  "procrustes": tm.PointError("procrustes")}
    ev = tev.Evaluator(alignments=alignments, device="cpu")
    seen = []
    real = tev.aligned_point_errors

    def spy(pairs, plain=False):
        seen.append([(names, root) for _, _, names, root in pairs])
        return real(pairs, plain)

    tev.aligned_point_errors = spy
    try:
        out = ev.compute_batch_metrics(
            {"stage_02": {"joints": est["joints"]}},
            {"gt_joints3d": torch.cat(
                [gt["joints"], torch.ones_like(gt["joints"][..., :1])], -1)})
    finally:
        tev.aligned_point_errors = real
    assert seen == [[(["root", "none", "procrustes"], (0,)),
                     (["root", "no"], (1, 2))]]
    for key, pe in alignments.items():
        want = pe(est["joints"], gt["joints"]).mean(dim=-1)
        assert torch.equal(out[f"mpjpe_{key}"], want), key


def test_group_rejects_unknown_alignments_and_keeps_empty_groups():
    x = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError, match="Unknown alignment"):
        tm.aligned_point_errors([(x, x, ("similarity",), None)])
    assert tm.aligned_point_errors([]) == []


PLAN_P = (1, 3, 14, 55, 1536, 1537, 2049, 10475, 20000, 72000)


@pytest.mark.parametrize("plan", [tm.align_plan, tm.regress_plan],
                         ids=["align", "regress"])
@pytest.mark.parametrize("B", [1, 32, 129])
@pytest.mark.parametrize("P", PLAN_P)
def test_plan_covers_every_point_once(plan, P, B):
    """A plan depends on (P, B) alone, takes 1 to 8 CTAs a body (the
    portable cluster) of at most 9000 points (their 24 bytes a point of
    shared memory), and its runs cover [0, P) once, in order."""
    cluster, span = plan(P, B)
    assert plan(P, B) == (cluster, span)
    assert 1 <= cluster <= 8 and 1 <= span <= tm._K8_MAX_SPAN
    runs = [range(min(P, r * span), min(P, (r + 1) * span))
            for r in range(cluster)]
    covered = [p for run in runs for p in run]
    assert covered == list(range(P))
    assert len(runs[0]) > 0


def test_plans_at_the_evaluators_shapes():
    assert tm.align_plan(10475, 32) == (4, 2619)
    assert tm.align_plan(55, 32) == (1, 55)
    assert tm.align_plan(14, 32) == (1, 14)
    assert tm.regress_plan(20000, 32) == (8, 2500)
    # fewer CTAs a body as the batch fills the card
    assert tm.align_plan(10475, 128) == (4, 2619)
    assert tm.align_plan(10475, 512) == (2, 5238)  # shared memory bounds it


@pytest.mark.parametrize("P,B", [(1, 1), (300, 2), (1537, 3), (20000, 1)])
def test_kernel_order_sum_counts_every_point_once(P, B):
    """Integer terms sum exactly in any order: the replay's order counts
    each point once (ones -> P, the index -> P(P - 1) / 2) and agrees with
    a plain f64 sum of random terms to rounding."""
    for plan, threads in ((tm.align_plan(P, B), tm._ALIGN_THREADS),
                          (tm.regress_plan(P, B), tm._REGRESS_THREADS)):
        idx = torch.arange(P, dtype=torch.float64)
        terms = torch.stack([torch.ones(P, dtype=torch.float64), idx], -1)
        got = tm.kernel_order_sum(terms.expand(B, P, 2), plan, threads)
        assert torch.equal(got, torch.tensor(
            [[float(P), P * (P - 1) / 2]] * B, dtype=torch.float64))
        x = torch.randn((B, P, 3), dtype=torch.float64)
        torch.testing.assert_close(tm.kernel_order_sum(x, plan, threads),
                                   x.sum(1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("names,root", [
    (ALIGNS, (1, 4, 7)), (("translation",), None), (("scale",), None),
    (("procrustes",), None), (("none",), None)])
def test_aligned_sums_replay_is_the_plain_sums(names, root):
    """K8b's totals as replayed: the coordinate sums, the f32-centred
    moments and the root sums, against plain f64 sums of the same terms
    (rounding apart); 0 where no alignment asks for them."""
    rng = np.random.default_rng(3)
    est, gt = (torch.from_numpy(_cloud(rng, 2, 1600)) for _ in range(2))
    got = tm.aligned_sums_replay(est, gt, names, root or (0,))
    modes = {tm._ALIGN_MODES[n] for n in names}
    want = torch.zeros_like(got)
    if modes & {2, 3, 4}:
        want[:, :6] = torch.cat([est, gt], -1).double().sum(1)
    if modes & {3, 4}:
        m = (want[:, :6] / est.shape[1]).float()
        x1 = (est - m[:, None, :3]).double()
        x2 = (gt - m[:, None, 3:]).double()
        want[:, 6] = (x1 * x1).sum((1, 2))
        if 3 in modes:
            want[:, 7] = (x2 * x2).sum((1, 2))
        if 4 in modes:
            want[:, 8:17] = torch.einsum("bpi,bpj->bij", x1, x2).reshape(
                -1, 9)
    if 1 in modes:
        want[:, 17:] = torch.cat([est, gt], -1)[:, list(root)].double().sum(1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-9)


def _regressor(rng, V, P, K):
    return tm.SparsePointRegressor(rng.integers(0, V, (P, K)),
                                   rng.dirichlet(np.ones(K), P),
                                   device="cpu")


def test_regressor_rows_sorted_once_and_plain_unchanged():
    """The regressor sorts its rows by their first vertex once (slot j holds
    row order[j]); on the CPU its call and ``point_regress_error`` with the
    sorted rows and their order give the unsorted rows' plain numbers bit
    for bit; a target's rows follow the same order; ``to`` keeps them."""
    rng = np.random.default_rng(4)
    reg, target = _regressor(rng, 120, 400, 3), _regressor(rng, 90, 400, 2)
    order = reg.order.long()
    assert sorted(order.tolist()) == list(range(400))
    first = reg.indices[order, 0]
    assert bool((first[1:] >= first[:-1]).all())
    v_in = torch.from_numpy(_cloud(rng, 2, 120))
    v_tgt = torch.from_numpy(_cloud(rng, 2, 90))
    for tr, vt in ((None, v_in + 0.1), (target, v_tgt)):
        idx1, w1, idx2, w2, o = reg.kernel_rows(tr)
        t = tr or reg
        assert torch.equal(idx2, t.indices[order])
        assert torch.equal(w2, t.weights[order])
        want = tm.point_regress_error_plain(v_in, vt,
                                            reg.indices, reg.weights,
                                            t.indices, t.weights)
        assert torch.equal(reg(v_in, vt, tr), want)
        assert torch.equal(tm.point_regress_error(
            v_in, vt, idx1, w1, idx2, w2, True, o), want)
    moved = reg.to("meta")
    assert moved.order.device.type == "meta" and moved._slots == {}


def test_regress_sums_replay_is_the_plain_sums():
    rng = np.random.default_rng(5)
    reg = _regressor(rng, 200, 2600, 3)
    v_in = torch.from_numpy(_cloud(rng, 2, 200))
    v_tgt = v_in + 0.5
    rows = reg.kernel_rows()[:4]
    got = tm.regress_sums_replay(v_in, v_tgt, *rows)
    want = torch.cat([reg.regress(v_in), reg.regress(v_tgt)],
                     -1).double().sum(1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    no_align = copy.copy(reg)
    no_align.align = False
    assert torch.equal(no_align(v_in, v_tgt), no_align.plain(v_in, v_tgt))
