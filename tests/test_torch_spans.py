"""The port's spans on the profiler's clock (`utils/phases.py`), on the CPU.

- With no profiler, no `recording()` and no SF_PROF a phase (and a
  `span` or a hot site's `call`) keeps no span and allocates nothing (one
  shared do-nothing context).
- Under a CPU profiler each kept span lies within 50 us of the profiler's
  host record of the same name, at both ends.
- Parents nest on one thread, roots are the thread's outermost span, and
  nothing nests across threads; beyond MAX_SPANS spans are counted as
  dropped.
- An eager CPU level (2 levels, alter 2, outer 3, no exit) keeps one
  `graph.flag_read` span per `read()` call, as many as the loops' closed
  form.
- Stage 3's `dt.alternate` is still a host record under a CPU profiler,
  inside `dt.call`, and the init's spans nest in `dt.init_final`.
- Timers and spans at once: `recording()` counts every phase's span, and
  times no `span` or `call` site, traced or not.
- On a card (`cuda`): a span around a synchronized kernel holds that
  kernel's device record.
"""
import contextlib
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slowflow_tpu_torch.utils import phases
from test_torch_tracking import one_torch_thread  # noqa: F401

SLACK_NS = 50_000


@pytest.fixture(autouse=True)
def fresh_spans(monkeypatch):
    monkeypatch.setattr(phases, "ENABLED", False)
    phases.clear_spans()
    yield
    phases.clear_spans()


def _host_records(prof) -> dict:
    out: dict = {}
    for ev in prof.profiler.kineto_results.events():
        out.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    return out


def test_no_span_and_no_allocation_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert phases.phase("a") is phases.phase("b") is phases.span("c")
    for _ in range(10):                       # warm the code paths
        with phases.phase("x"), phases.span("y"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with phases.phase("x"), phases.span("y"):
                pass
            phases.call("x", int)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == phases.__file__ and d.size_diff > 0]
    assert grown == []
    assert phases.spans() == ([], 0)


def _nested_block():
    with phases.phase("outer"):
        with phases.phase("inner"):
            torch.ones(1000).cumsum(0)
        time.sleep(0.002)
        with phases.phase("inner"):
            torch.ones(1000).cumsum(0)


def test_spans_match_the_profilers_host_records():
    """A thread preempted between the record's clock read and the span's
    stamp moves one end by the preemption: one of three traced runs must
    match throughout."""
    worst = None
    for _ in range(3):
        phases.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _nested_block()
        kept, dropped = phases.spans()
        assert dropped == 0
        assert [s.name for s in kept] == ["outer", "inner", "inner"]
        records = _host_records(prof)
        assert len(records["outer"]) == 1 and len(records["inner"]) == 2
        off = max(max(abs(s.start_ns - a), abs(s.end_ns - b))
                  for s, (a, b) in zip(kept, records["outer"]
                                       + sorted(records["inner"])))
        worst = off if worst is None else min(worst, off)
        if worst <= SLACK_NS:
            break
    assert worst <= SLACK_NS, worst


def test_parents_nest_on_one_thread_and_not_across_threads(monkeypatch):
    # the profiler records the thread it started on alone: here every
    # thread polls as recording, so the worker keeps spans too
    monkeypatch.setattr(phases, "_profiling", lambda: True)

    def worker():
        with phases.phase("w.root"):
            with phases.phase("w.child"):
                pass

    with phases.phase("root"):
        with phases.phase("child"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            with phases.phase("grandchild"):
                pass
        with phases.phase("child2"):
            pass
    kept, _ = phases.spans()
    by = {s.name: (i, s) for i, s in enumerate(kept)}
    i_root, root = by["root"]
    assert root.parent is None and root.root == i_root
    for name, parent in (("child", "root"), ("grandchild", "child"),
                         ("child2", "root")):
        _, s = by[name]
        assert s.parent == by[parent][0] and s.root == i_root
        assert s.thread == root.thread
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    i_w, w_root = by["w.root"]
    _, w_child = by["w.child"]
    assert w_root.parent is None and w_root.root == i_w
    assert w_child.parent == i_w and w_child.root == i_w
    assert w_root.thread == w_child.thread != root.thread


def test_spans_beyond_the_bound_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(phases, "_profiling", lambda: True)
    monkeypatch.setattr(phases, "MAX_SPANS", 2)
    with phases.phase("a"):
        with phases.phase("b"):
            with phases.phase("c"):
                with phases.phase("d"):
                    pass
    kept, dropped = phases.spans()
    assert [s.name for s in kept] == ["a", "b"] and dropped == 2
    assert kept[1].parent == 0 and all(s.end_ns is not None for s in kept)


def test_recording_counts_every_span():
    with phases.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]):
        _nested_block()
    kept, _ = phases.spans()
    assert rec["outer"][1] == 1 and rec["inner"][1] == 2
    assert sum(n for _, n in rec.values()) == len(kept)


@pytest.mark.parametrize("traced", [False, True])
def test_span_and_call_sites_are_never_timed(traced):
    traced_by = profile(activities=[ProfilerActivity.CPU]) if traced \
        else contextlib.nullcontext()
    with phases.recording() as rec, traced_by:
        with phases.span("s"):
            assert phases.call("c", int, "7") == 7
    assert rec == {}
    kept, _ = phases.spans()
    assert [s.name for s in kept] == (["s", "c"] if traced else [])


def _tiny_level_call(p):
    from slowflow_tpu_torch.variational.multiframe import \
        variational_mt_batched

    rng = np.random.default_rng(7)
    b, h, w = 1, 24, 28
    seq = torch.tensor(rng.random((b, 2 * p.ref + 1, 3, h, w)),
                       dtype=torch.float32)
    zero = torch.zeros((b, h, w))
    return variational_mt_batched(zero, zero, seq, p, device="cpu")


def test_flag_reads_of_an_eager_level_match_the_closed_form(monkeypatch):
    from slowflow_tpu_torch.variational import multiframe as tmf
    from slowflow_tpu_torch.variational.params import MultiFrameParams

    # thresholds below any change: no loop exits early
    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                         niter_alter=2, niter_outer=3, niter_inner=1,
                         niter_solver=5, thres_outer=-1.0, thres_inner=-1.0)
    calls = []
    read = tmf._Level.read

    def counted(self):
        calls.append(1)
        return read(self)

    monkeypatch.setattr(tmf._Level, "read", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tiny_level_call(p)
    kept, _ = phases.spans()
    reads = [s for s in kept if s.name == "graph.flag_read"]
    first = 1 if tmf.first_system(p) else 0
    # per level: the alternation's reads from the second on, and each
    # alternation's outer reads from its first outer iteration on
    closed = p.layers * ((p.niter_alter - 1)
                         + p.niter_alter * (p.niter_outer - first))
    assert len(reads) == len(calls) == closed
    assert {s.name for s in kept} == {"sf.call", "graph.flag_read"}
    assert all(kept[s.parent].name == "sf.call" for s in reads)
    assert len(_host_records(prof)["graph.flag_read"]) == closed


def test_stage3_spans_are_host_records_under_a_cpu_profiler():
    from slowflow_tpu_torch.tracking import driver as drv
    from test_tracking_batched import _job

    cfg = drv.TrackingConfig(
        jets=3, rates=1, skip_pixel=1, alternate=2, epic_interpolation=False,
        neigh_hyp=2, hyp_neigh_tryouts=4, trws_max_iter=5, capacity=8,
        acc_bc=0.0, acc_gc=0.0, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv.track_final_pairs_batched(cfg, [_job(1.0, 0.5, 0)],
                                      np.zeros(1, np.float32), device="cpu")
    records = _host_records(prof)
    assert len(records["dt.alternate"]) == cfg.alternate
    kept, _ = phases.spans()
    idx = {s.name: i for i, s in enumerate(kept)}
    for name in ("dt.alternate", "dt.init_final", "dt.readback",
                 "dt.select", "dt.propagate"):
        assert kept[kept[idx[name]].root].name == "dt.call", name
    for name in ("dt.accumulate", "dt.evaluate"):
        assert kept[kept[idx[name]].parent].name == "dt.init_final", name
    assert sum(s.name == "dt.alternate" for s in kept) == cfg.alternate


@pytest.mark.cuda
def test_a_span_holds_its_synchronized_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x = torch.ones((4096, 4096), device="cuda")
    (x @ x).sum().item()                      # warm the kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with phases.phase("span"):
            y = x @ x
            torch.cuda.synchronize()
    kept, _ = phases.spans()
    (span,) = [s for s in kept if s.name == "span"]
    events = list(prof.profiler.kineto_results.events())
    host = {e.name() for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA}
    kernels = [(e.end_ns() - e.start_ns(), e.start_ns(), e.end_ns())
               for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.name() not in host]
    assert kernels, "no kernel record"
    _, a, b = max(kernels)                    # the matmul
    assert span.start_ns <= a and b <= span.end_ns
    del y
