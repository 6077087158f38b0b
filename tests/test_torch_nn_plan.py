"""K9's design replayed on the CPU (``shapy_tpu_torch/eval/metrics.py``):
the plan's split of both directions into query blocks and ranges of b,
the run minima and the first index, held against ``nn_dists_plain`` and
the JAX package's ``_nn_dists``; and ``point_fscore`` through
``nn_dists_both``.

The replay repeats what kernel K9 (``csrc/nn_dists.cu``) does; the kernel
runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Tolerances: distances and neighbour indices
bit-equal to the plain version (-2 folded into a, which is exact);
against JAX 1e-5 m, as ``test_torch_eval.py`` (a matmul's FMAs round the
expansion otherwise, so near-ties may pick another neighbour).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.eval import metrics as jm
from shapy_tpu_torch.eval import metrics as tm
from shapy_tpu_torch.utils.vec3 import dot3


def _clouds(N, M, seed=0, ties=True):
    """Seeded clouds of a body's extent; with ``ties``, b holds duplicates
    and points equidistant from a query (a[0] at the origin; two points
    0.01 m either side of it on x, a third on y)."""
    rng = np.random.default_rng(seed)
    scale = np.asarray([0.3, 0.8, 0.2])
    a = (rng.normal(size=(N, 3)) * scale).astype(np.float32)
    b = (rng.normal(size=(M, 3)) * scale).astype(np.float32)
    if ties and M > 12:
        b[5] = b[3]
        b[M - 1] = b[2]
        a[0] = 0.0
        b[7], b[8], b[11] = [0.01, 0, 0], [-0.01, 0, 0], [0, 0.01, 0]
    return a, b


def _first_argmin(a, b):
    """The plain version's neighbour: the first index of the least f32
    expansion, summed as ``nn_dists_plain`` sums it."""
    d2 = dot3(a, a)[:, None] - 2.0 * dot3(a[:, None], b[None]) \
        + dot3(b, b)[None]
    return torch.argmin(d2, dim=1)


@pytest.mark.parametrize("N, M", [(500, 700), (300, 5), (1, 1), (64, 4200),
                                  (2100, 2500)])
@pytest.mark.parametrize("both", [False, True])
def test_replay_is_bit_equal_to_plain(N, M, both):
    a, b = (torch.from_numpy(x) for x in _clouds(N, M))
    plans = tm.nn_plan(N, M, both)
    for (p, q), plan in zip(((a, b), (b, a)), plans):
        d, idx = tm.nn_search_replay(p, q, plan)
        assert torch.equal(d, tm.nn_dists_plain(p, q))
        assert torch.equal(idx, _first_argmin(p, q))


def test_ties_keep_the_first_index():
    a, b = (torch.from_numpy(x) for x in _clouds(500, 700))
    d, idx = tm.nn_search_replay(a, b, tm.nn_plan(500, 700)[0])
    assert int(idx[0]) == 7 and float(d[0]) == np.float32(0.01)
    # every duplicate in b points back at its first copy
    d, idx = tm.nn_search_replay(b, b, tm.nn_plan(700, 700)[0])
    assert int(idx[5]) == 3 and int(idx[699]) == 2
    assert bool((d == 0).all())


@pytest.mark.parametrize("span", [5000, 2049, 16, 17])
def test_replay_over_tiles_and_ranges(span):
    """Ranges longer than a staged tile (2048 points), and ranges that end
    inside a run of 16: the same bits and indices as the plain version."""
    a, b = (torch.from_numpy(x) for x in _clouds(200, 5000, seed=3))
    plan = tm.NNPlan(1, -(-5000 // span), span)
    d, idx = tm.nn_search_replay(a, b, plan)
    assert torch.equal(d, tm.nn_dists_plain(a, b))
    assert torch.equal(idx, _first_argmin(a, b))


@pytest.mark.parametrize("N, M", [(500, 700), (700, 500)])
def test_replay_agrees_with_jax(N, M):
    a, b = _clouds(N, M, seed=5, ties=False)
    for p, q in ((a, b), (b, a)):
        plan = tm.nn_plan(len(p), len(q))[0]
        got = tm.nn_search_replay(torch.from_numpy(p), torch.from_numpy(q),
                                  plan)[0]
        want = np.asarray(jm._nn_dists(jnp.asarray(p), jnp.asarray(q)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_point_fscore_through_both_directions():
    """``point_fscore`` takes ``nn_dists_both``: bit-equal to two
    ``_nn_dists`` calls and to the F-score of their distances."""
    a, b = (torch.from_numpy(x) for x in _clouds(500, 700, seed=7))
    d_ab, d_ba = tm.nn_dists_both(a, b)
    assert torch.equal(d_ab, tm._nn_dists(a, b))
    assert torch.equal(d_ba, tm._nn_dists(b, a))
    for thresh in (0.005, 0.01, 0.02):
        got = tm.point_fscore(a, b, thresh)
        want = tm.fscore_from_dists(tm._nn_dists(a, b), tm._nn_dists(b, a),
                                    thresh)
        for k in want:
            assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="empty"):
        tm.nn_dists_both(a[:0], b)
    with pytest.raises(ValueError, match="empty"):
        tm.nn_dists_both(a, b[:0])


@pytest.mark.parametrize("N, M", [(10475, 10475), (10475, 20000), (1, 1),
                                  (5, 100000), (3000, 7)])
@pytest.mark.parametrize("both", [False, True])
def test_plan_is_a_function_of_the_shapes(N, M, both):
    plans = tm.nn_plan(N, M, both)
    assert plans == tm.nn_plan(N, M, both)
    assert len(plans) == (2 if both else 1)
    per = tm._NN_THREADS * tm._NN_R
    for (n, m), plan in zip(((N, M), (M, N)), plans):
        # every query in a block, every point of b in one range
        assert (plan.blocks - 1) * per < n <= plan.blocks * per
        assert (plan.ranges - 1) * plan.span < m <= plan.ranges * plan.span
        assert plan.span >= min(m, tm._NN_MIN_SPAN)
    total = sum(p.blocks * p.ranges for p in plans)
    assert total <= 2 * tm._NN_TARGET_CTAS
    if (N, M) == (10475, 10475) and both:
        assert plans == (tm.NNPlan(11, 6, 1746),) * 2
