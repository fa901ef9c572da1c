"""The sp row split of one level in its graph form (variational/multiframe.py
`_GraphedStrips`, parallel/strips.py, variational/graphs.py), on the CPU.

The graph form runs here without a capture: `graphs.running` is replaced by
one that hands out a Program stand-in per key, whose inputs and state are
`graphs.Slots` (tensors that keep their memory and are written by copies).
Each segment runs under `graphs.cutting`, as in a capture: the stand-in
records each host step (a collective between ranks, where a capture is
cut) and runs it where it stands, and keeps each count (the exchange
counter) and runs it after the segment, as a replay does. Programs are
kept per key, so a second call runs over the same Slots and the same kept
Strips, as replays do. Each "equals" below is bitwise, against the eager
strip level and against `compute_one_level` on the whole image:

- the merged, stack and unfused routes with one and two inner
  iterations, on 1x2 and 2x2 meshes of "cpu", with equal exchange and
  widening counts;
- a flow that widens the windows: one Program per window geometry;
- two ranks on ["cpu", "cpu:0"] (one host thread each): both cut at the
  same points in the same order, the exit flags are ORed over the ranks
  (a placement where the ranks' own flags differ), and a rank that fails
  in a host step aborts the barrier, so the call raises and nothing hangs;
  with one rank nothing is cut; two callers of two-rank plans at once,
  their ranks handed to the shared rank threads interleaved, both return;
- the cache key tells apart the geometries, ranks, placements and images;
- the CPU never captures;
- the slice check: the JAX package's sp path at
  test_sp_matches_the_jax_sp_path's bound, with the level in graph form.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from unittest import mock

import pytest

import test_torch_sp
from slowflow_tpu_torch.parallel import mesh as pmesh
from slowflow_tpu_torch.parallel import strips as pstrips
from slowflow_tpu_torch.variational import graphs
from slowflow_tpu_torch.variational import multiframe as tmf
from test_torch_sp import (  # noqa: F401
    P, ROUTES, _equal, _mesh, _scene, one_torch_thread)


class _Cuts:
    """A segment's record under `graphs.cutting`: its host steps by name,
    and its counts, run after the segment as a replay runs them."""

    def __init__(self):
        self.steps: list = []
        self.counts: list = []

    def cut(self, step):
        self.steps.append(step.__code__.co_names[-1])
        return step()


class _Uncaptured:
    """A Program without CUDA: Slots for inputs and state, each segment
    called as it comes under `graphs.cutting`; `log` gets (segment, host
    steps) in order."""

    graphed = True

    def __init__(self, log):
        self.inputs, self.state = graphs.Slots(), graphs.Slots()
        self.level = self.keep = None
        self.log = log

    def run(self, segment, fn):
        with graphs.cutting(_Cuts()) as cuts:
            fn()
        for count in cuts.counts:
            count()
        self.log.append((segment, tuple(cuts.steps)))


@contextlib.contextmanager
def graph_form():
    """While open, compute_one_level with strips runs its graph form on the
    CPU over stand-ins kept per key. Yields (the stand-ins by key, the
    (segment, host steps) log of each host thread)."""
    progs, logs = {}, {}
    lock = threading.Lock()

    @contextlib.contextmanager
    def running(key, device, graphed, shared=False):
        assert graphed and not shared
        with lock:
            log = logs.setdefault(threading.current_thread().name, [])
            prog = progs.setdefault(key, _Uncaptured(log))
        yield prog

    def level(*args, p, strips=None):
        assert strips is not None
        return tmf._graphed_strip_level(*args, p, strips)

    with mock.patch.object(graphs, "running", running), \
            mock.patch.object(tmf, "compute_one_level", level):
        yield progs, logs


def _bounded(fn, seconds=120):
    """fn() on a thread of its own; if it has not returned in `seconds`,
    every barrier of the strip plans made meanwhile is aborted (so no rank
    thread stays blocked) and the test fails. Returns fn's result or
    raises its error."""
    groups, out = [], {}
    init = pstrips._Group.__init__

    def recorded(self, n):
        init(self, n)
        groups.append(self)

    def call():
        try:
            out["result"] = fn()
        except Exception as e:          # noqa: BLE001
            out["error"] = e

    with mock.patch.object(pstrips._Group, "__init__", recorded):
        t = threading.Thread(target=call, daemon=True)
        t.start()
        t.join(seconds)
        hung = t.is_alive()
        if hung:
            for group in groups:
                group.barrier.abort()
            t.join(seconds)
    assert not hung, f"the ranks hung (no result in {seconds} s)"
    if "error" in out:
        raise out["error"]
    return out["result"]


def _three_ways(p, args, mesh, calls=2):
    """The unsharded level, the eager strip level and `calls` calls of the
    graph form on `mesh`: all equal; the graph form's counts equal the
    eager ones. Returns the eager plan and the graph form's stand-ins and
    logs."""
    want = tmf.compute_one_level(*args, p=p)
    eager, plan = pstrips.run_strips(mesh, p, *args)
    _equal(eager, want)
    with graph_form() as (progs, logs):
        for _ in range(calls):
            got, gplan = pstrips.run_strips(mesh, p, *args)
            _equal(got, eager)
            assert (gplan.exchanges, gplan.widenings) == (
                plan.exchanges, plan.widenings)
            assert gplan.geometry == plan.geometry
    assert plan.exchanges > 0
    return plan, progs, logs


@pytest.mark.parametrize("niter_inner", [1, 2])
@pytest.mark.parametrize("route", ["merged", "stack", "unfused"])
@pytest.mark.parametrize("shape", [(1, 2, 71), (2, 2, 70)],
                         ids=lambda m: "{}x{}_h{}".format(*m))
def test_graph_form_equals_eager(shape, route, niter_inner):
    n_jet, n_sp, h = shape
    p = dataclasses.replace(P, niter_inner=niter_inner, **ROUTES[route])
    plan, progs, logs = _three_ways(p, _scene(2, h, 20), _mesh(n_jet, n_sp))
    # one rank: every collective is device work, so nothing is cut
    assert plan.group.n == 1 and list(logs) == [
        threading.current_thread().name]
    assert all(steps == () for _, steps in logs[threading.current_thread()
                                                .name])
    assert len(progs) == plan.widenings + 1


@pytest.mark.parametrize("route", ["merged", "unfused"])
def test_graph_form_widens_into_a_program_per_geometry(route):
    """test_sp_flow_of_several_pixels_in_y's widening case: the flow grows
    from 1 px to ~1.8 px and the windows widen on the way; each geometry
    has its own Program (its own kept Strips), and the second call
    replays through the same ones."""
    p = dataclasses.replace(P, niter_alter=3, niter_outer=3, **ROUTES[route])
    args = _scene(1, 96, 16, v=-3.0, wy0=-1.0)
    plan, progs, _ = _three_ways(p, args, _mesh(1, 3))
    assert plan.widenings > 0
    assert len(progs) == plan.widenings + 1
    ghosts = sorted(prog.keep.geometry.ghost for prog in progs.values())
    assert len(set(ghosts)) == len(ghosts) and ghosts[-1] == \
        plan.geometry.ghost
    # the widened state was carried: segments ran in every geometry
    assert all(prog.state.__dict__ for prog in progs.values())


@pytest.mark.parametrize("n_jet", [1, 2])
def test_two_ranks_cut_at_the_same_points(n_jet):
    """Two host threads, each a rank: every segment that exchanges or sums
    over ranks is cut at each collective, at the same points in the same
    order on both, and the result and counts are the eager ones, with a
    widening on the way."""
    p = dataclasses.replace(P, niter_outer=3)
    devices = ["cpu", "cpu:0"] * n_jet
    plan, progs, logs = _three_ways(p, _scene(2, 70, 16, v=-2.0),
                                    _mesh(n_jet, 2, devices))
    assert plan.group.n == 2 and plan.widenings > 0
    assert len(logs) == 2 and all(name.startswith("strip-rank")
                                  for name in logs)
    rank0, rank1 = logs.values()
    assert rank0 == rank1
    steps = [s for _, cut in rank0 for s in cut]
    assert {"_swap", "_gathered_total"} <= set(steps)
    # the alternation top relabels, solves and sums: it is cut
    assert any(seg[0] == "top" and cut for seg, cut in rank0)
    assert len(progs) == 2 * (plan.widenings + 1)


def test_exit_flags_are_ored_over_ranks():
    """Jet 0's strips on one rank, jet 1's on the other, and jet 0 (a still
    scene) leaves its loops before jet 1: in the graph form the ranks' own
    flags differ at some host read, and every rank still runs the loop
    while either has a live jet, as the eager split and the whole image
    do."""
    p = dataclasses.replace(P, niter_alter=3, niter_outer=4,
                            thres_outer=2e-3)
    args = _scene(2, 70, 16)
    args[2][0] = args[2][0, 2:3]          # jet 0: every frame the same
    mesh = _mesh(2, 2, ["cpu", "cpu", "cpu:0", "cpu:0"])
    want = tmf.compute_one_level(*args, p=p)
    eager, plan = pstrips.run_strips(mesh, p, *args)
    _equal(eager, want)
    seen = []
    real = pstrips.Strips.any

    def any_(self, flag):
        seen.append((self.rank, bool(flag.any())))
        return real(self, flag)

    with graph_form(), mock.patch.object(pstrips.Strips, "any", any_):
        got, gplan = _bounded(lambda: pstrips.run_strips(mesh, p, *args))
    _equal(got, eager)
    assert gplan.exchanges == plan.exchanges
    reads = [dict(seen[i:i + 2]) for i in range(0, len(seen), 2)]
    assert reads and all(len(r) == 2 for r in reads)
    assert any(r[0] != r[1] for r in reads), reads


def test_a_rank_failing_in_a_host_step_does_not_hang_the_others():
    """In the graph form a rank that raises inside a host step (its part
    of an exchange) aborts the barrier: the call raises instead of leaving
    the other rank waiting, and the next call runs."""
    args = _scene(2, 70, 16)
    real = pstrips.Strips._swap

    def swap(self, *a):
        if self.rank == 1:
            raise RuntimeError("exchange failed on rank 1")
        return real(self, *a)

    with graph_form(), mock.patch.object(pstrips.Strips, "_swap", swap), \
            pytest.raises(RuntimeError, match="rank 1"):
        _bounded(lambda: pstrips.run_strips(_mesh(1, 2, ["cpu", "cpu:0"]),
                                            P, *args), seconds=60)
    with graph_form():
        got, _ = pstrips.run_strips(_mesh(1, 2, ["cpu", "cpu:0"]), P, *args)
    _equal(got, tmf.compute_one_level(*args, p=P))


def test_two_callers_at_once_do_not_deadlock():
    """Two host threads call run_strips with two-rank plans at once; the
    first pauses between handing its two ranks to the rank threads (which
    every caller shares) while the second hands over both of its own. Each
    rank thread still takes the calls in one order, so neither call waits
    at a barrier for a rank queued behind the other's, and both return the
    whole image's result."""
    args = _scene(2, 70, 16)
    mesh = _mesh(1, 2, ["cpu", "cpu:0"])
    want = tmf.compute_one_level(*args, p=P)
    real = pmesh._worker
    a_paused, b_handed = threading.Event(), threading.Event()

    def worker(i, kind="shard"):
        name = threading.current_thread().name
        if name == "caller-a" and i == 1:
            a_paused.set()
            b_handed.wait(2.0)      # times out where the calls are ordered
            time.sleep(0.2)
        if name == "caller-b" and i == 1:
            b_handed.set()
        return real(i, kind)

    def two_callers():
        out = {}

        def call(name):
            if name == "caller-b":
                a_paused.wait(10.0)
            out[name] = pstrips.run_strips(mesh, P, *args)[0]

        threads = [threading.Thread(target=call, args=(n,), name=n)
                   for n in ("caller-a", "caller-b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    with mock.patch.object(pmesh, "_worker", worker):
        out = _bounded(two_callers, seconds=60)
    assert sorted(out) == ["caller-a", "caller-b"]
    for got in out.values():
        _equal(got, want)


def test_cache_key_tells_geometries_apart():
    def key(b=2, h=70, n_sp=2, placement=None, rank=0, max_wy=0.0):
        placement = placement or ["cpu"] * (b * n_sp)
        plan = pstrips.StripPlan(P, b, h, n_sp, placement, max_wy)
        return pstrips.Strips(plan, rank).key()

    base = key()
    assert key() == base
    two = ["cpu", "cpu:0"] * 2
    others = [key(h=71), key(n_sp=3, placement=["cpu"] * 6),
              key(max_wy=1.5), key(b=3, placement=["cpu"] * 6),
              key(placement=two), key(placement=two, rank=1),
              key(placement=["cpu", "cpu", "cpu:0", "cpu:0"])]
    assert len({base, *others}) == len(others) + 1
    plan = pstrips.StripPlan(P, 2, 70, 2, ["cpu"] * 4)
    strips = pstrips.Strips(plan, 0)
    wider = pstrips.Strips(plan, 0, pstrips.Geometry(70, 2, plan.cone + 2))
    assert wider.key() != strips.key()
    assert wider.table != strips.table


def test_cpu_never_captures():
    graphs.clear()
    graphs.reset_stats()
    args = _scene(2, 40, 12)
    p = dataclasses.replace(P, niter_alter=2)
    pstrips.run_strips(_mesh(1, 2), p, *args)
    pstrips.run_strips(_mesh(1, 2, ["cpu", "cpu:0"]), p, *args)
    assert graphs.STATS == {"captures": 0, "replays": 0, "capture_s": 0.0}
    assert graphs.cached_keys() == []


def test_graph_form_sp_matches_the_jax_sp_path():
    """test_sp_matches_the_jax_sp_path's bound with the port's level in its
    graph form."""
    with graph_form() as (progs, _):
        test_torch_sp.test_sp_matches_the_jax_sp_path()
    assert progs
