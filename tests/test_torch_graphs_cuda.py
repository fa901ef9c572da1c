"""CUDA graphs of the port's jet solve on the card (variational/graphs.py):
the captured level bitwise equal to the eager level on each route, with
occlusion reasoning and one or two inner iterations; a second batch of the
same shape replayed without a new capture; a capture made while another
host thread launches K2 on its own stream (the stage-2 CLI's EPIC prefetch
pattern); each kernel wrapper captured and replayed against its eager call
(K1 / K5's cooperative launch included); the launch counters counting
replays. Every test needs a CUDA GPU and skips without one.

    python -m pytest tests/test_torch_graphs_cuda.py -m cuda
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.bench_scene import moving_sequence
from slowflow_tpu_torch.core import solver_pallas, warp_pallas, warp_shift
from slowflow_tpu_torch.variational import (fused_data, fused_solve,
                                            fused_warp, graphs, multiframe)
from slowflow_tpu_torch.variational.multiframe import (
    compute_one_level, variational_mt_batched, variational_mt_sharded)
from slowflow_tpu_torch.variational.params import MultiFrameParams

P = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0, rho=(1.0, 1.0),
                     omega=(0.0, 2.0), niter_solver=30, smoothing=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs and the kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _planes(n, b, h, w, seed, device, lo=0.5, hi=1.5):
    rng = np.random.default_rng(seed)
    return [torch.tensor(lo + (hi - lo) * rng.random((b, h, w)),
                         dtype=torch.float32, device=device)
            for _ in range(n)]


def _captured(fn):
    """fn() warmed up and captured on a side stream; returns (graph, the
    captured call's outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        g.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return g, out


def _kernel_calls(device):
    b, h, w = 2, 37, 70
    t = _planes(12, b, h, w, 3, device)
    seq = torch.tensor(np.random.default_rng(4).random((b, 5, 3, h, w)) * 255,
                       dtype=torch.float32, device=device)
    wx, wy = (0.7 * x for x in _planes(2, b, h, w, 5, device, -1, 1))
    cw = torch.ones((b, 3, h, w), device=device)
    p = MultiFrameParams(**{**P.__dict__, "S": 3})
    _, _, reg = p.penalties()
    warped, masks = warp_shift.warp_stack(seq, wx, wy, p.ref)
    mask = masks[:, :4].contiguous()
    return {
        "solve_step": lambda: fused_solve.solve_step(
            *t[:8], t[8], t[9], alpha=p.alpha, reg_pen=reg, method=1,
            iterations=30, omega=1.9, with_change=True),
        "sor": lambda: solver_pallas.sor_coupled_rb_pallas(
            t[8], t[9], *t[2:7], t[10], t[11], iterations=30, omega=1.9),
        "warp_assemble": lambda: fused_warp.warp_assemble(
            seq, wx, wy, None, None, None, cw, p, mode="occ_assembly",
            zero_duv=True),
        "fused_data": lambda: fused_data.fused_data_system(
            warped, mask, None, None, cw, p, mode="occ", zero_duv=True),
        "warp_stack": lambda: warp_shift.warp_stack(seq, wx, wy, p.ref),
        "warp_stack_pallas": lambda: warp_pallas.warp_stack_pallas(
            seq, wx, wy, [-2.0, -1.0, 0.0, 1.0, 2.0]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["solve_step", "sor", "warp_assemble",
                                  "fused_data", "warp_stack",
                                  "warp_stack_pallas"])
def test_captured_kernel_equals_eager(cuda_device, name):
    """Stream capture takes each wrapper's launch (K1 / K5's cooperative
    one included); the replay equals the eager call bitwise."""
    fn = _kernel_calls(cuda_device)[name]
    want = fn()
    g, out = _captured(fn)
    for o in out:
        o.zero_()
    g.replay()
    torch.cuda.synchronize()
    for o, x in zip(out, want):
        assert torch.equal(o, x), name


ROUTES = {"merged": {},
          "stack": dict(merge_warp=False, fused_solve=False),
          "unfused": dict(pallas_warp=True, fused_solve=False)}
LEVEL = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0,
                         rho=(1.0, 1.0), omega=(0.0, 2.0), niter_alter=4,
                         niter_outer=4, niter_solver=10,
                         occlusion_reasoning=True, smoothing=1)


def _level_inputs(device, b=2, h=46, w=70, seed=0):
    seq = torch.tensor(np.stack([moving_sequence(5, h, w, 1.2 + 0.3 * j,
                                                 -0.6, seed=seed + j)
                                 for j in range(b)]), dtype=torch.float32,
                       device=device)
    rng = np.random.default_rng(seed)
    wx, wy = (torch.tensor(0.3 * rng.standard_normal((b, h, w)),
                           dtype=torch.float32, device=device)
              for _ in range(2))
    cw = torch.tensor(0.5 + rng.random((b, 3, h, w)), dtype=torch.float32,
                      device=device)
    return (wx, wy, seq, cw, torch.zeros((b, 3), device=device),
            torch.ones((b, 3), device=device))


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _eager_pipeline(*args):
    """variational_mt_batched(*args) with every level eager."""
    with mock.patch.object(multiframe, "compute_one_level", functools.partial(
            compute_one_level, _eager=True)):
        return variational_mt_batched(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("niter_inner", [1, 2])
@pytest.mark.parametrize("route", list(ROUTES))
def test_captured_level_equals_eager(cuda_device, route, niter_inner):
    p = dataclasses.replace(LEVEL, niter_inner=niter_inner, **ROUTES[route])
    args = _level_inputs(cuda_device)
    graphs.clear()
    graphs.reset_stats()
    want = compute_one_level(*args, p=p, _eager=True)
    first = compute_one_level(*args, p=p)          # first runs + captures
    captured = graphs.STATS["captures"]
    again = compute_one_level(*args, p=p)          # replays only
    assert captured > 0 and graphs.STATS["captures"] == captured
    assert graphs.STATS["replays"] > 0
    assert _equal(first, want) and _equal(again, want)


@pytest.mark.cuda
def test_second_batch_replays_without_capture(cuda_device):
    p = dataclasses.replace(LEVEL, layers=2)
    graphs.clear()
    a = _level_inputs(cuda_device, seed=1)
    b = _level_inputs(cuda_device, seed=2)
    variational_mt_batched(a[0], a[1], a[2], p, a[3], a[4], a[5])
    captured = graphs.STATS["captures"]
    got = variational_mt_batched(b[0], b[1], b[2], p, b[3], b[4], b[5])
    assert graphs.STATS["captures"] == captured
    want = _eager_pipeline(b[0], b[1], b[2], p, b[3], b[4], b[5])
    assert _equal(got, want)
    # a smaller last batch is another shape: new graphs, the old kept
    small = variational_mt_batched(b[0][:1], b[1][:1], b[2][:1], p,
                                   b[3][:1], b[4][:1], b[5][:1])
    assert graphs.STATS["captures"] > captured
    assert len(graphs.cached_keys()) == 4
    assert _equal(small, _eager_pipeline(b[0][:1], b[1][:1], b[2][:1], p,
                                         b[3][:1], b[4][:1], b[5][:1]))


@pytest.mark.cuda
def test_capture_beside_a_launching_thread(cuda_device):
    """Another host thread keeps launching K2 on its own stream (and
    allocating its outputs) while this one captures the level."""
    p = LEVEL
    args = _level_inputs(cuda_device)
    seq, wx, wy, cw = args[2], args[0], args[1], args[3]
    stop, started, calls, errors = (threading.Event(), threading.Event(),
                                    [], [])

    def prefetch():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
                while not stop.is_set():
                    calls.append(fused_warp.warp_assemble(
                        seq, wx, wy, None, None, None, cw, p, mode="occ",
                        zero_duv=True)[0].sum().item())
                    started.set()
        except Exception as e:       # reported below
            errors.append(e)
            started.set()

    want = compute_one_level(*args, p=p, _eager=True)
    graphs.clear()
    worker = threading.Thread(target=prefetch)
    worker.start()
    started.wait(60)
    try:
        n0 = len(calls)
        got = compute_one_level(*args, p=p)
        n1 = len(calls)
    finally:
        stop.set()
        worker.join()
    assert not errors, errors
    assert n1 > n0, "the other thread launched nothing during the capture"
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_launch_counters_count_replays(cuda_device, route):
    p = dataclasses.replace(LEVEL, **ROUTES[route])
    args = _level_inputs(cuda_device)
    graphs.clear()
    counts = []
    for eager in (True, False, False):     # eager, first run, replays
        kernels.reset_launch_counts()
        compute_one_level(*args, p=p, _eager=eager)
        counts.append(dict(kernels.LAUNCHES))
    assert counts[0] == counts[1] == counts[2]
    assert sum(counts[0].values()) > 0


@pytest.mark.cuda
def test_two_shards_replay_on_their_threads(cuda_device):
    p = dataclasses.replace(LEVEL, layers=2)
    wx, wy, seq, cw, na, ns = _level_inputs(cuda_device, b=4)
    devs = [cuda_device, cuda_device]
    graphs.reset_stats()
    first = variational_mt_sharded(wx, wy, seq, p, devs, cw, na, ns)
    captured = graphs.STATS["captures"]
    again = variational_mt_sharded(wx, wy, seq, p, devs, cw, na, ns)
    assert graphs.STATS["captures"] == captured
    assert _equal(first, again)
    halves = [_eager_pipeline(wx[i:i + 2], wy[i:i + 2], seq[i:i + 2], p,
                              cw[i:i + 2], na[i:i + 2], ns[i:i + 2])
              for i in (0, 2)]
    assert _equal(first, [torch.cat(parts) for parts in zip(*halves)])
