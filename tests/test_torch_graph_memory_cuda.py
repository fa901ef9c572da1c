"""Graph memory in a long-lived process (variational/graphs.py), on the
card.

- One host thread runs more than `graphs.MAX_PROGRAMS` distinct shapes
  (two stage-3 final pairs, jet-solve levels, two-frame solves): the
  oldest Programs are dropped and their memory handed back, so reserved
  memory after the sweep stays within the reserve at the 16th Program plus
  the largest step's growth, and dropping every Program brings it back to
  where it started (within 256 MiB); after the sweep once more a level of
  another shape captures, with no empty_cache by the caller, bitwise its
  eager form.
- With the device's memory held in the allocator's cache (filled, then
  freed), a first capture releases the cache beforehand and succeeds,
  bitwise the eager solve.
Every test needs a CUDA GPU and skips without one.

    python -m pytest tests/test_torch_graph_memory_cuda.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.bench_scene import (moving_sequence, stage3_config,
                                            stage3_final_pair)
from slowflow_tpu_torch.tracking import driver
from slowflow_tpu_torch.variational import graphs, multiframe, twoframe
from slowflow_tpu_torch.variational.params import MultiFrameParams

P_LEVEL = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0,
                           rho=(1.0, 1.0), omega=(0.0, 2.0), niter_alter=2,
                           niter_outer=2, niter_solver=10,
                           occlusion_reasoning=True, smoothing=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs have no CPU mode)")
    graphs.clear()
    graphs.clear_shared()
    yield torch.device("cuda")
    graphs.clear()
    graphs.clear_shared()


def _level(b, h, w, dev, eager=False):
    seq = torch.tensor(np.stack([moving_sequence(5, h, w, 1.2, -0.6, seed=s)
                                 for s in range(b)]), dtype=torch.float32,
                       device=dev)
    z = torch.zeros((b, h, w), device=dev)
    out = multiframe.compute_one_level(
        z, z, seq, torch.ones((b, 3, h, w), device=dev),
        torch.zeros((b, 3), device=dev), torch.ones((b, 3), device=dev),
        P_LEVEL, _eager=eager)
    torch.cuda.synchronize()
    return out


def _twoframe(b, h, w, dev, eager=False):
    seq = np.stack([moving_sequence(2, h, w, 1.2, -0.6, seed=s)
                    for s in range(b)])
    rng = np.random.default_rng(b)
    args = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        1.2 + rng.normal(0, 0.3, (b, h, w)), np.full((b, h, w), -0.6),
        seq[:, 0], seq[:, 1])]
    out = twoframe.variational_twoframe_batched(
        *args, twoframe.TwoFrameParams.sintel(), _eager=eager)
    torch.cuda.synchronize()
    return out


def _stage3(h, w, dev):
    job, _ = stage3_final_pair(h=h, w=w, jets=3, device=dev)
    driver.track_final_pairs_batched(stage3_config(jets=3, alternate=2),
                                     [job], device=dev)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_reserved_memory_stays_bounded_over_many_shapes(cuda_device):
    dev = cuda_device
    # after the 16th Program, shapes of the sizes before it (a stage-3 pair
    # of as many pixels first): without handing dropped pools back, their
    # growth would add up beyond the largest step's
    sweep = ([lambda: _stage3(64, 96, dev)]
             + [lambda i=i: _level(2, 40 + 8 * i, 48 + 8 * i, dev)
                for i in range(10)]
             + [lambda b=b: _twoframe(b, 60, 80, dev) for b in (1, 2, 3, 4)]
             + [lambda: _stage3(96, 64, dev)]
             + [lambda b=b: _twoframe(b, 60, 80, dev) for b in (5, 6)]
             + [lambda i=i: _level(2, 44 + 8 * i, 52 + 8 * i, dev)
                for i in range(2)])
    graphs.reset_stats()
    start = torch.cuda.memory_reserved()
    reserved, growth, programs = [], [], []
    for step in sweep:
        before = torch.cuda.memory_reserved()
        step()
        reserved.append(torch.cuda.memory_reserved())
        growth.append(reserved[-1] - before)
        programs.append(len(graphs.cached_keys()))
    at_16 = programs.index(next(n for n in programs
                                if n >= graphs.MAX_PROGRAMS))
    assert programs[-1] == graphs.MAX_PROGRAMS
    assert graphs.RELEASES["on_close"] > 0
    assert reserved[-1] <= reserved[at_16] + max(growth)
    graphs.clear()
    graphs.clear_shared()
    assert torch.cuda.memory_reserved() <= start + 2 ** 28
    for step in sweep:
        step()
    got = _level(3, 96, 128, dev)
    want = _level(3, 96, 128, dev, eager=True)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


@pytest.mark.cuda
def test_first_capture_with_the_memory_in_the_cache(cuda_device):
    dev = cuda_device
    want = _twoframe(16, 135, 240, dev, eager=True)
    hog = []
    for size in (2 ** 30, 2 ** 26):
        while True:
            try:
                hog.append(torch.empty(size, dtype=torch.uint8, device=dev))
            except torch.cuda.OutOfMemoryError:
                break
    assert torch.cuda.mem_get_info()[0] < 2 ** 27
    del hog
    graphs.reset_stats()
    got = _twoframe(16, 135, 240, dev)
    assert graphs.STATS["captures"] == 1
    assert graphs.RELEASES["before_capture"] == 1
    for g, e in zip(got, want):
        assert torch.equal(g, e)
