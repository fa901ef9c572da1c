"""Stage 3 and the EPIC distance transform as CUDA graphs on the card
(tracking/driver.py, tracking/mrf.py, epic/distance.py over
variational/graphs.py), each against its eager form (`_eager=True`) on the
same card, bitwise:

- the bench final pair (bench_scene.stage3_final_pair, 270x480, Jets 10,
  EPIC on) cut to 2 alternations: the bank's flows and occlusions, the
  unaries and pairwise costs, the labels, energies and bounds of every
  solve, the flows and occlusion maps;
- the distance transform at the stage-2 init's shape (4 x 270 x 480) and
  stage 3's (10 x 135 x 240);
- a second call replays without a capture, the distance transforms of the
  init workers included;
- a capture succeeds while another host thread launches on its own stream
  (the CLIs' prefetch pattern);
- the replay counter counts replays, and no hand kernel is counted.
Every test needs a CUDA GPU and skips without one.

    python -m pytest tests/test_torch_stage3_graphs_cuda.py -m cuda
"""
from __future__ import annotations

import dataclasses
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.bench_scene import stage3_config, stage3_final_pair
from slowflow_tpu_torch.epic import distance
from slowflow_tpu_torch.tracking import driver, mrf
from slowflow_tpu_torch.variational import graphs
from test_tracking_batched import CFG, _job
from test_torch_tracking import EPIC_CFG, _epic_job


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs have no CPU mode)")
    graphs.clear()
    graphs.clear_shared()
    yield torch.device("cuda")
    graphs.clear()
    graphs.clear_shared()


def _recorded_run(cfg, jobs, device, eager, **kw):
    """track_final_pairs_batched with every solve's inputs and outputs and
    the readback's bank recorded (copied: in the graph form they are slots
    that later replays overwrite)."""
    solves, banks = [], []
    solve, readback = driver.solve_multilabel, driver._readback

    def rec_solve(unary, cost_r, cost_d, **args):
        out = solve(unary, cost_r, cost_d, **args)
        solves.append(tuple(t.clone() for t in (unary, cost_r, cost_d)
                            + tuple(out)))
        return out

    def rec_readback(flows, occl, selected, J, xy_incr):
        banks.append((flows.clone(), occl.clone(), selected.clone()))
        return readback(flows, occl, selected, J, xy_incr)

    with mock.patch.object(driver, "solve_multilabel", rec_solve), \
            mock.patch.object(driver, "_readback", rec_readback):
        flows, occs, _ = driver.track_final_pairs_batched(
            cfg, jobs, device=device, _eager=eager, **kw)
    return flows, occs, solves, banks


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (tuple, list)):
            _same(g, w)
        elif isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_bench_final_pair_captured_equals_eager(cuda_device):
    cfg = stage3_config(alternate=2)
    job, _ = stage3_final_pair(seed=0, device=cuda_device)
    with mock.patch.object(distance, "distance_transform",
                           lambda *a, **k: _eager_dt(*a, **k)):
        want = _recorded_run(cfg, [job], cuda_device, True)
    graphs.reset_stats()
    first = _recorded_run(cfg, [job], cuda_device, False)
    captures = graphs.STATS["captures"]
    again = _recorded_run(cfg, [job], cuda_device, False)
    assert captures > 0 and graphs.STATS["captures"] == captures
    for got in (first, again):
        _same(got, want)
    assert len(want[2]) == cfg.alternate


_dt = distance.distance_transform


def _eager_dt(*args, **kw):
    return _dt(*args, **kw, _eager=True)


def _dt_inputs(b, h, w, device, seed):
    rng = np.random.default_rng(seed)
    cost = (0.02 + rng.random((b, h, w))).astype(np.float32)
    sd = np.full((b, h, w), distance.BIG, np.float32)
    sl = np.full((b, h, w), -1, np.int32)
    for i in range(b):
        n = 400
        xs, ys = rng.integers(0, w, n), rng.integers(0, h, n)
        sd[i, ys, xs] = cost[i, ys, xs]
        sl[i, ys, xs] = np.arange(n, dtype=np.int32)
    return [torch.as_tensor(a, device=device) for a in (cost, sd, sl)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w", [(4, 270, 480), (10, 135, 240)])
def test_distance_transform_captured_equals_eager(cuda_device, b, h, w):
    args = _dt_inputs(b, h, w, cuda_device, w)
    want = distance.distance_transform(*args, _eager=True)
    graphs.reset_stats()
    for _ in range(2):
        got = distance.distance_transform(*args)
        _same(got, want)
    assert graphs.STATS["captures"] == 1
    assert graphs.STATS["replays"] > 0
    # a max_iter cut, on the same graph
    cut = distance.distance_transform(*args, max_iter=12)
    _same(cut, distance.distance_transform(*args, max_iter=12, _eager=True))
    assert graphs.STATS["captures"] == 1


@pytest.mark.cuda
def test_second_call_replays_init_workers_included(cuda_device):
    cfg = dataclasses.replace(EPIC_CFG, alternate=3)
    jobs = [_epic_job(_job(1.0, 0.5, s)) for s in (0, 1)]
    wj = np.zeros(1, np.float32)
    draws = driver.default_draws(cfg.seed, cuda_device)
    want = driver.track_final_pairs_batched(
        cfg, jobs, wj, device=cuda_device, draws=draws, init_workers=2,
        _eager=True)
    graphs.reset_stats()
    first = driver.track_final_pairs_batched(
        cfg, jobs, wj, device=cuda_device, draws=draws, init_workers=2)
    captures = graphs.STATS["captures"]
    assert graphs.shared_keys(), "the init's distance transforms kept none"
    kernels.reset_launch_counts()
    replays = graphs.STATS["replays"]
    again = driver.track_final_pairs_batched(
        cfg, jobs, wj, device=cuda_device, draws=draws, init_workers=2)
    assert graphs.STATS["captures"] == captures
    assert graphs.STATS["replays"] > replays
    assert not any(kernels.LAUNCHES.values())     # no hand kernel here
    for got in (first, again):
        _same(got[0], want[0])
        _same(got[1], want[1])


@pytest.mark.cuda
def test_capture_beside_a_launching_thread(cuda_device):
    jobs = [_job(1.0, 0.5, 0)]
    wj = np.zeros(1, np.float32)
    draws = driver.default_draws(CFG.seed, cuda_device)
    want = driver.track_final_pairs_batched(CFG, jobs, wj, device=cuda_device,
                                            draws=draws, _eager=True)
    stop = threading.Event()
    errors = []

    def prefetch():
        try:
            stream = torch.cuda.Stream(cuda_device)
            # a generator of its own: the default one belongs to a capture
            # while it runs, and may not advance outside it
            gen = torch.Generator(cuda_device).manual_seed(0)
            with torch.cuda.stream(stream):
                x = torch.rand((512, 512), device=cuda_device, generator=gen)
                while not stop.is_set():
                    x = (x @ x).tanh()
                    x.sum().item()
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)

    other = threading.Thread(target=prefetch)
    other.start()
    try:
        graphs.reset_stats()
        got = driver.track_final_pairs_batched(CFG, jobs, wj,
                                               device=cuda_device,
                                               draws=draws)
    finally:
        stop.set()
        other.join()
    assert not errors
    assert graphs.STATS["captures"] > 0
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.cuda
def test_solve_replays_count(cuda_device):
    rng = np.random.default_rng(3)
    u = torch.tensor(20 * rng.random((2, 12, 14, 4)), dtype=torch.float32,
                     device=cuda_device)
    r = torch.tensor(rng.random((2, 12, 14, 4, 4)), dtype=torch.float32,
                     device=cuda_device)
    want = mrf.solve_multilabel(u, r, r, iters=6, _eager=True)
    graphs.reset_stats()
    _same(mrf.solve_multilabel(u, r, r, iters=6), want)
    first = dict(graphs.STATS)
    _same(mrf.solve_multilabel(u, r, r, iters=6), want)
    assert graphs.STATS["captures"] == first["captures"] == 3   # start, trw,
    assert graphs.STATS["replays"] - first["replays"] \
        == first["replays"] + first["captures"]           # tail
