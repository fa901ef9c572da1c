"""Stage 3 and the EPIC distance transform in their graph form
(tracking/driver.py `_Alternation`, tracking/mrf.py `_Solve`,
epic/distance.py `_DT`, variational/graphs.py), on the CPU.

The graph form runs here without a capture: `graphs.running` is replaced
by one that hands out a Program stand-in whose inputs and state are
`graphs.Slots` (tensors that keep their memory and are written by copies)
and whose segments write the loop-exit flag that the host reads between
them, as on CUDA, with each segment called where a graph would be replayed.
Programs are kept per key, so a second call runs over the same Slots, as a
replay does. Each "equals" below is bitwise:

- the TRW / BP solve equals the eager solve (labels, energy, bound and
  messages) for approach 0 and 1, with F = 1 and with F = 2 where the two
  problems stop at different iterations;
- one propagation pass equals the eager pass, with a case where every
  final pair adopts its `want` proposals before the last tryout group (the
  break) and an F = 2 case where only one final pair does;
- `track_final_pairs_batched` equals the eager call on
  tests/test_torch_tracking.py's cases and stays within
  test_track_final_pair_matches_jax's bounds against the JAX package, with
  the JAX draws injected;
- the distance transform in blocks equals the eager one on
  tests/test_torch_epic.py's geometries, with a `max_iter` cut;
- the cache keys tell apart configs that differ in one field, and shapes;
  the CPU never captures;
- the distance transform's shared Programs are lent to one host thread at
  a time, under many threads switching often.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.epic import distance
from slowflow_tpu_torch.tracking import driver as drv
from slowflow_tpu_torch.tracking import mrf
from slowflow_tpu_torch.variational import graphs
from test_torch_epic import _geometry, _seeded
from test_torch_tracking import (  # noqa: F401
    EPIC_CFG, MULTI_CFG, _agree, _epic_job, _run_jax, jax_draws,
    one_torch_thread)
from test_tracking_batched import CFG, _job, _job_multirate
from test_trws_oracle import _bench_shaped_problem

CPU = torch.device("cpu")


class _Uncaptured:
    """A Program without CUDA: Slots for inputs and state, segments called
    as they come, each recorded."""

    graphed = True

    def __init__(self):
        self.inputs, self.state = graphs.Slots(), graphs.Slots()
        self.level = None
        self.segments = []

    def run(self, segment, fn):
        self.segments.append(segment)
        fn()


@contextlib.contextmanager
def graph_form():
    """While open, every graphs.running call (the alternation, the solve,
    the distance transform) gets the stand-in kept for its key. Yields the
    dict of stand-ins by key."""
    progs = {}

    @contextlib.contextmanager
    def running(key, device, graphed, shared=False):
        yield progs.setdefault(key, _Uncaptured())

    with mock.patch.object(graphs, "running", running):
        yield progs


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the solve
@pytest.fixture(scope="module")
def problem():
    """tests/test_torch_mrf.py's problem (16x18, K = 4)."""
    return tuple(torch.as_tensor(np.array(a))
                 for a in _bench_shaped_problem(h=16, w=18, K=4, seed=2))


def _eager_solve(unary, cost_r, cost_d, iters, approach, eps):
    st = SimpleNamespace(unary=unary, cost_r=cost_r, cost_d=cost_d)
    segments = []
    mrf._Solve(st, iters, approach, 0.5, eps).drive(
        lambda segment, fn: (segments.append(segment), fn()))
    return st, segments


@pytest.mark.parametrize("approach, iters, eps, scales", [
    (0, 10, 1e-5, (1.0,)), (0, 30, 1e-3, (1.0, 0.01)),
    (1, 10, 1e-5, (1.0,)), (1, 7, 1e-5, (1.0, 0.01))],
    ids=["trw-F1", "trw-F2", "bp-F1", "bp-F2"])
def test_solve_graph_form_equals_eager(problem, approach, iters, eps,
                                       scales):
    unary, cost_r, cost_d = problem
    u = torch.stack([unary] * len(scales))
    r = torch.stack([s * cost_r for s in scales])
    d = torch.stack([s * cost_d for s in scales])
    want, _ = _eager_solve(u, r, d, iters, approach, eps)
    out = mrf.solve_multilabel(u, r, d, iters, approach, eps=eps)
    _equal(out, (want.labels, want.energy, want.best))
    with graph_form() as progs:
        for _ in range(2):                       # the second over the same
            got = mrf.solve_multilabel(u, r, d, iters, approach, eps=eps)
            _equal(got, out)
    (prog,) = progs.values()
    _equal(prog.state.msgs, want.msgs)
    assert prog.state.labels.dtype == torch.int32
    if approach == 0 and len(scales) == 2:
        # each problem alone stops at its own iteration, both before the
        # cap; side by side, the pair runs until the later one stops
        stops = [_eager_solve(u[f:f + 1], r[f:f + 1], d[f:f + 1], iters,
                              approach, eps)[1].count(("trw",))
                 for f in range(2)]
        assert stops[0] != stops[1] and max(stops) < iters, stops
        assert prog.segments.count(("trw",)) == 2 * max(stops)
        for f in range(2):
            one = mrf.solve_multilabel(u[f], r[f], d[f], iters, approach,
                                       eps=eps)
            _equal(tuple(x[f] for x in out), one)


# ------------------------------------------------------ the propagation
def _init(cfg, jobs, wj):
    """The stacked initial banks, consistent masks and fields of `jobs`."""
    states = [drv._init_final_state(cfg, j, wj, CPU, {}) for j in jobs]
    state = {k: torch.cat([s[k] for s in states]) for k in states[0]}
    bank = {k: state.pop(k) for k in ("flows", "occl", "energy", "valid",
                                      "jet_est")}
    return bank, state.pop("consistent"), state, torch.as_tensor(wj)


def _pass(cfg, bank, consistent, fields, wj, p_it, prog):
    """One sorted bank's propagation pass over `prog`'s inputs and state."""
    ins, st = prog.inputs, prog.state
    ins.fields, ins.consistent, ins.weight_jet = fields, consistent, wj
    st.bank = bank
    alt = drv._Alternation(cfg, ins, st, prog.graphed)
    prog.run(("sort_first",), lambda: alt.sort(True))
    alt.propagate(prog.run, drv.default_draws(cfg.seed, CPU), p_it)
    return st.bank


def _recorded():
    prog = graphs.Eager()
    prog.segments = []

    def run(segment, fn):
        prog.segments.append(segment)
        fn()

    prog.run = run
    return prog


def _tryouts(prog):
    return [s for s in prog.segments if s[0] == "tryouts"]


BREAK_CFG = dataclasses.replace(CFG, neigh_hyp=1, hyp_neigh_tryouts=20,
                                traj_sim_thres=0.0)


@pytest.mark.parametrize("case", ["default", "break", "break-one-of-two"])
def test_propagation_graph_form_equals_eager(case):
    cfg = CFG if case == "default" else BREAK_CFG
    jobs = [_job(1.0, 0.5, 0)] + ([_job(-0.7, 0.3, 1)]
                                  if case != "break" else [])
    wj = np.zeros(1, np.float32)
    bank, consistent, fields, wj_t = _init(cfg, jobs, wj)
    if case == "break-one-of-two":
        # final 1 keeps one valid hypothesis, at a lattice point: its
        # pixels rarely find a source, so it never reaches `want`
        bank["valid"][1] = False
        bank["valid"][1, 5, 5, 0] = True
    p_it = 0 if case == "default" else 1
    eager = _recorded()
    want = _pass(cfg, bank, consistent, fields, wj_t, p_it, eager)
    ngroups = 2 * len(range(0, cfg.hyp_neigh_tryouts, 4))
    for _ in range(2):
        prog = _Uncaptured()
        _equal(_pass(cfg, bank, consistent, fields, wj_t, p_it, prog), want)
        assert prog.segments == eager.segments
    assert all(s[3] == (p_it == 0) for s in _tryouts(eager))
    if case == "break":
        assert len(_tryouts(eager)) < ngroups / 2, _tryouts(eager)
    if case == "break-one-of-two":
        # the pair runs every group; final 0 stopped where it stops alone
        assert len(_tryouts(eager)) == ngroups
        alone = _recorded()
        first = _pass(cfg, {k: v[:1] for k, v in bank.items()},
                      consistent[:1], {k: v[:1] for k, v in fields.items()},
                      wj_t, p_it, alone)
        assert len(_tryouts(alone)) < ngroups / 2
        _equal({k: v[:1] for k, v in want.items()}, first)


# ----------------------------------------------------------- the driver
def _batched(cfg, jobs, wj, **kw):
    return drv.track_final_pairs_batched(cfg, jobs, wj, device="cpu",
                                         draws=jax_draws(cfg.seed), **kw)


@pytest.mark.parametrize("case", ["single", "multirate_occ", "epic"])
def test_track_final_pair_graph_form_equals_eager(case):
    if case == "single":
        cfg, job, wj = CFG, _job(1.0, 0.5, 0), np.zeros(1, np.float32)
    elif case == "multirate_occ":
        cfg, job = MULTI_CFG, _job_multirate(1.0, 0.5, 0)
        wj = np.array([0.0, 1.0], np.float32)
    else:
        cfg, job = EPIC_CFG, _epic_job(_job(-0.7, 0.3, 1))
        wj = np.zeros(1, np.float32)
    flows, occs, info = _batched(cfg, [job], wj)
    with graph_form() as progs:
        for _ in range(2):
            g_flows, g_occs, g_info = _batched(cfg, [job], wj)
            _equal(g_flows, flows)
            _equal(g_occs, occs)
            assert g_info["variables"] == info["variables"]
            assert set(g_info["timing"]) == set(info["timing"])
    kinds = {k[0] for k in progs}
    assert {"stage3", "mrf"} <= kinds
    assert ("dt" in kinds) == (case == "epic")
    (alt,) = [p for k, p in progs.items() if k[0] == "stage3"]
    assert ("sort_first",) in alt.segments and ("nms",) in alt.segments
    flow_j, occ_j, _ = _run_jax(cfg, job, wj, epic=case == "epic")
    _agree(g_flows[0], g_occs[0], flow_j, occ_j)


def test_batched_graph_form_equals_eager():
    """Two final pairs with threaded initialization, as the CLI batches
    them."""
    jobs = [_job(1.0, 0.5, 0), _job(-0.7, 0.3, 1)]
    wj = np.zeros(1, np.float32)
    flows, occs, _ = _batched(CFG, jobs, wj)
    with graph_form():
        g_flows, g_occs, _ = _batched(CFG, jobs, wj, init_workers=2)
    _equal(g_flows, flows)
    _equal(g_occs, occs)


# ------------------------------------------------ the distance transform
@pytest.mark.parametrize("max_iter, check_every", [(256, 8), (12, 8),
                                                   (256, 3)])
@pytest.mark.parametrize("geometry", ["uniform", "wall", "random"])
def test_distance_transform_graph_form_equals_eager(geometry, max_iter,
                                                    check_every):
    cost, seeds = _geometry(geometry)
    sd, sl = _seeded(cost, seeds)
    args = [torch.tensor(np.stack([a, a[::-1].copy()])) for a in
            (cost, sd, sl)]
    want = distance.distance_transform(*args, max_iter, check_every)
    with graph_form() as progs:
        for _ in range(2):
            got = distance.distance_transform(*args, max_iter, check_every)
            _equal(got, want)
    (prog,) = progs.values()
    blocks = len(prog.segments) // 2
    assert blocks * check_every >= min(max_iter, 1)
    if max_iter == 12:
        assert blocks == 2                       # cut, as eagerly
        assert not torch.equal(
            want[0], distance.distance_transform(*args, 256, check_every)[0])


# ------------------------------------------------------- keys, the CPU
def _other(value):
    if isinstance(value, bool):
        return not value
    return value + 1 if isinstance(value, int) else value * 1.5 + 0.25


def test_cache_keys_tell_configs_and_shapes_apart():
    cfg = drv.TrackingConfig(jets=10, rates=1, skip_pixel=1)
    key = drv.stage3_key(cfg, "cuda:0", 1, 135, 240, False, 1)
    assert key == drv.stage3_key(dataclasses.replace(cfg), torch.device(
        "cuda:0"), 1, 135, 240, False, 1)
    host = {"jets", "rates", "consistency_threshold", "discard_inconsistent",
            "use_jet_occlusions", "epic_interpolation", "epic_skip",
            "alternate", "penalty_fct_reg", "penalty_fct_reg_eps", "seed",
            "capacity"}
    fields = {f.name for f in dataclasses.fields(cfg)}
    assert fields == host | set(drv.GRAPH_FIELDS) | set(drv.SOLVE_FIELDS)
    for name in drv.GRAPH_FIELDS:
        other = dataclasses.replace(cfg, **{name: _other(getattr(cfg, name))})
        assert drv.stage3_key(other, "cuda:0", 1, 135, 240, False, 1) != key, \
            name
    for name in ("jets", "capacity"):        # J and K
        other = dataclasses.replace(cfg, **{name: getattr(cfg, name) + 1})
        assert drv.stage3_key(other, "cuda:0", 1, 135, 240, False, 1) != key
    for args in (("cuda:1", 1, 135, 240, False, 1),
                 ("cuda:0", 2, 135, 240, False, 1),
                 ("cuda:0", 1, 134, 240, False, 1),
                 ("cuda:0", 1, 135, 241, False, 1),
                 ("cuda:0", 1, 135, 240, True, 1),
                 ("cuda:0", 1, 135, 240, False, 2)):
        assert drv.stage3_key(cfg, *args) != key
    # the solve's fields key its own graphs
    skey = mrf.solve_key("cuda:0", (1, 135, 240, 16), 10, 0, 0.5, 1e-5)
    for args in ((("cuda:0", (1, 135, 240, 16), 11, 0, 0.5, 1e-5)),
                 (("cuda:0", (1, 135, 240, 16), 10, 1, 0.5, 1e-5)),
                 (("cuda:0", (1, 135, 240, 16), 10, 0, 0.6, 1e-5)),
                 (("cuda:0", (1, 135, 240, 16), 10, 0, 0.5, 1e-4)),
                 (("cuda:0", (2, 135, 240, 16), 10, 0, 0.5, 1e-5)),
                 (("cuda:0", (1, 135, 240, 8), 10, 0, 0.5, 1e-5)),
                 (("cuda:1", (1, 135, 240, 16), 10, 0, 0.5, 1e-5))):
        assert mrf.solve_key(*args) != skey
    z = torch.zeros((4, 135, 240))
    lab = torch.zeros((4, 135, 240), dtype=torch.int32)
    dkey = distance.dt_key(z, z, lab, 8)
    assert dkey == distance.dt_key(z.clone(), z, lab, 8)
    for other in (distance.dt_key(z[:2], z[:2], lab[:2], 8),
                  distance.dt_key(z[..., 1:], z[..., 1:], lab[..., 1:], 8),
                  distance.dt_key(z, z, lab, 4),
                  distance.dt_key(z.double(), z, lab, 8)):
        assert other != dkey


def test_cpu_never_captures(problem):
    graphs.clear()
    graphs.clear_shared()
    graphs.reset_stats()
    mrf.solve_multilabel(*problem, iters=3)
    cost, seeds = _geometry("random")
    sd, sl = _seeded(cost, seeds)
    distance.distance_transform(torch.tensor(cost), torch.tensor(sd),
                                torch.tensor(sl))
    _batched(EPIC_CFG, [_epic_job(_job(-0.7, 0.3, 1))],
             np.zeros(1, np.float32), init_workers=2)
    assert graphs.STATS == {"captures": 0, "replays": 0, "capture_s": 0.0}
    assert graphs.cached_keys() == [] and graphs.shared_keys() == []


def test_running_hands_the_eager_path_plain_namespaces():
    with graphs.running(("any",), "cpu", graphed=False) as prog:
        assert not prog.graphed and prog.level is None
        prog.state.x = torch.zeros(2)
        prog.state.x = torch.ones(3)             # rebinds, copies nothing
        assert prog.state.x.shape == (3,)
        ran = []
        prog.run(("seg",), lambda: ran.append(1))
        assert ran == [1]


def test_shared_programs_are_lent_to_one_thread_at_a_time():
    class Fake:
        def __init__(self):
            self.users, self.closed = 0, False

        def close(self):
            self.closed = True

    errors = []

    def borrow(i):
        for n in range(400):
            key = ("dt", (i + n) % 3)
            prog = graphs._take_shared(key) or Fake()
            prog.users += 1
            if prog.users != 1 or prog.closed:
                errors.append((key, prog.users, prog.closed))
            prog.users -= 1
            graphs._give_back(key, prog)

    graphs.clear_shared()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=borrow, args=(i,))
               for i in range((os.cpu_count() or 4) + 4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert 0 < len(graphs.shared_keys()) <= graphs.MAX_PROGRAMS
    graphs.clear_shared()
    assert graphs.shared_keys() == []
