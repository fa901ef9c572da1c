"""The port's selection MRF (`slowflow_tpu_torch.tracking.mrf`) against the
JAX package's, the sequential TRW-S oracle (tests/trws_oracle.py) and the
goldens (tests/golden/goldens.npz), on the CPU.

Tolerances: labels >= 99 % equal to JAX's (an argmin over beliefs summed in
another float order can flip a near-tie, and one more or one fewer TRW
iteration under the eps exit moves a few pixels); the labeling energy and
the pairwise costs within 1e-5 relative; the goldens' labels equal and their
energy within 1e-5 relative, as tests/test_golden.py holds the JAX package.
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowflow_tpu.tracking import mrf as jmrf
from slowflow_tpu_torch.tracking import mrf
from test_torch_tracking import one_torch_thread  # noqa: F401
from test_trws_oracle import _bench_shaped_problem
from trws_oracle import SequentialTRWS

GOLD = pathlib.Path(__file__).parent / "golden" / "goldens.npz"


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def problem():
    """The selection MRF's structure at 16x18, K = 4 (invalid slots +BIG,
    trajectory-distance pairwise costs from the JAX package's
    pairwise_costs)."""
    return _bench_shaped_problem(h=16, w=18, K=4, seed=2)


@pytest.mark.parametrize("approach, eps", [(0, 1e-5), (0, 0.0), (1, 1e-5)],
                         ids=["trw", "trw-no-exit", "bp"])
def test_solve_multilabel_matches_jax(problem, approach, eps):
    unary, cost_r, cost_d = problem
    labels_j, energy_j, lb_j = jmrf.solve_multilabel(
        jnp.asarray(unary), jnp.asarray(cost_r), jnp.asarray(cost_d),
        iters=10, approach=approach, eps=eps)
    labels, energy, lb = mrf.solve_multilabel(T(unary), T(cost_r), T(cost_d),
                                              iters=10, approach=approach,
                                              eps=eps)
    assert labels.dtype == torch.int32
    assert (labels.numpy() == np.asarray(labels_j)).mean() >= 0.99
    assert abs(float(energy) - float(energy_j)) <= 1e-5 * abs(float(energy_j))
    assert abs(float(lb) - float(lb_j)) <= 1e-5 * abs(float(lb_j)) + 1e-3


def test_solve_multilabel_batched_equals_alone(problem):
    """Two problems side by side stop on their own tests: each equals its
    solve alone."""
    unary, cost_r, cost_d = problem
    u2 = np.stack([unary, unary[::-1, ::-1].copy()])
    r2 = np.stack([cost_r, cost_r[::-1, ::-1].copy()])
    d2 = np.stack([cost_d, cost_d[::-1, ::-1].copy()])
    labels, energy, lb = mrf.solve_multilabel(T(u2), T(r2), T(d2), iters=10)
    for f in range(2):
        one = mrf.solve_multilabel(T(u2[f]), T(r2[f]), T(d2[f]), iters=10)
        np.testing.assert_array_equal(labels[f].numpy(), one[0].numpy())
        assert float(energy[f]) == float(one[1])
        assert float(lb[f]) == float(one[2])


def test_bound_below_the_oracle(problem):
    """The chain-decomposition bound stays <= the sequential TRW-S oracle's
    labeling energy and <= its own labeling energy, and the labeling is
    within 2 % of the oracle's energy (tests/test_trws_oracle.py)."""
    unary, cost_r, cost_d = problem
    _, energy_orc, _ = SequentialTRWS(unary, cost_r, cost_d).run(iters=30)
    for it in (1, 4, 30):
        _, energy, lb = mrf.solve_multilabel(T(unary), T(cost_r), T(cost_d),
                                             iters=it, approach=0, eps=-1e30)
        assert float(lb) <= energy_orc + 1e-3
        assert float(lb) <= float(energy) + 1e-3
    assert (float(energy) - energy_orc) / abs(energy_orc) < 0.02


def test_pairwise_costs_match_jax():
    rng = np.random.default_rng(4)
    h, w, K, J = 7, 9, 3, 4
    flows = np.cumsum(rng.normal(0, 0.5, (h, w, K, J, 2)), -2).astype(
        np.float32)
    flows[2, 3, 1] = 1e10
    occl = (rng.random((h, w, K, J + 1)) < 0.3).astype(np.int32)
    sw = rng.random((2 * h + 1, 2 * w + 1)).astype(np.float32)
    for method in (1, 2):
        got = mrf.pairwise_costs(T(flows), T(occl), T(sw), 10.0, 10.0, method,
                                 2, 1)
        want = jmrf.pairwise_costs(flows, occl, sw, 10.0, 10.0, method, 2, 1)
        for g, t in zip(got, want):
            t = np.asarray(t)
            assert np.abs(g.numpy() - t).max() <= 1e-5 * np.abs(t).max()


def test_mrf_goldens():
    gold = dict(np.load(GOLD))
    rng = np.random.default_rng(6)               # make_goldens.golden_mrf
    h, w, K = 16, 18, 4
    unary = rng.random((h, w, K)).astype(np.float32) * 3
    cost = np.broadcast_to(0.7 * (1 - np.eye(K, dtype=np.float32)),
                           (h, w, K, K)).copy()
    for name, approach in (("mrf_labels", 0), ("mrf_labels_bp", 1)):
        labels, energy, _ = mrf.solve_multilabel(T(unary), T(cost), T(cost),
                                                 iters=20, approach=approach)
        np.testing.assert_array_equal(labels.numpy(), gold[name])
        assert abs(float(energy) - float(gold[name + "_energy"])) <= \
            1e-5 * abs(float(gold[name + "_energy"]))
