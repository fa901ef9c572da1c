"""The EPIC layer and the two-frame solve on the card against the same
functions on the CPU, at odd sizes and batches of 1 and 5: the stage-2
preprocess (Lab, saliency, edges) within 1e-5 of the plane max; the grid
matcher's kept matches row for row on textured pairs; the distance
transform's distances within 1e-5 relative with identical labels; and
`variational_twoframe_batched` at B = 40, 64x80 through K5 (the CPU side is
K5's plain twin): one outer iteration within 1e-3 px max, the sintel preset
with a median |dflow| <= 1e-3 px and a mean <= 1e-2 px (nvcc's FMA
contraction, amplified by the robust weights over five warps). Every test
needs a CUDA GPU and skips without one.

    python -m pytest tests/test_torch_epic_cuda.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.cli import slow_flow
from slowflow_tpu_torch.epic import distance, matching
from slowflow_tpu_torch.variational import twoframe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.cpu() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _textured(rng, shape, k=3):
    from scipy.ndimage import uniform_filter

    x = (rng.random(shape) * 255).reshape(-1, *shape[-2:])
    return uniform_filter(x, size=(1, k, k)).reshape(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w", [(1, 37, 53), (5, 29, 41)])
def test_preprocess_on_the_card(cuda_device, b, h, w):
    frames = np.round(np.random.default_rng(b).random((b, 3, h, w)) * 255)
    staged = slow_flow.stage_window_8bit(frames, cuda_device)
    assert staged.dtype == torch.uint8
    got = slow_flow.preprocess_frames(staged, chunk=3)
    want = slow_flow.preprocess_frames(
        slow_flow.stage_window_8bit(frames, torch.device("cpu")), chunk=3)
    assert _rel(got[0], want[0]) <= 1e-5
    for g, t in zip(got[1:], want[1:]):
        assert _rel(torch.as_tensor(g), torch.as_tensor(t)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w, radius", [(1, 37, 53, 6), (5, 45, 61, 9)])
def test_grid_matches_on_the_card(cuda_device, b, h, w, radius):
    rng = np.random.default_rng(h)
    base = _textured(rng, (b, 3, h + 8, w + 8)).astype(np.float32)
    im1 = base[..., 4:4 + h, 4:4 + w]
    im2 = base[..., 2:2 + h, 7:7 + w]
    got = matching.grid_matches_batched(torch.tensor(im1, device=cuda_device),
                                        torch.tensor(im2, device=cuda_device),
                                        radius=radius)
    want = matching.grid_matches_batched(im1, im2, radius=radius,
                                         device="cpu")
    for g, t in zip(got, want):
        assert len(t) > 0
        np.testing.assert_array_equal(g, t)


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w", [(1, 33, 47), (5, 31, 29)])
def test_distance_transform_on_the_card(cuda_device, b, h, w):
    rng = np.random.default_rng(w)
    costs = [(0.02 + rng.random((h, w))).astype(np.float32) for _ in range(b)]
    seeds = [np.stack([rng.integers(0, w, 25), rng.integers(0, h, 25)],
                      1).astype(np.int32) for _ in range(b)]
    nns = [10] * b
    got = distance.dist_trf_nnfield_batched(seeds, costs, nns,
                                            device=cuda_device)
    want = distance.dist_trf_nnfield_batched(seeds, costs, nns, device="cpu")
    for (gb, gd, gl, gm), (tb, td, tl, tm) in zip(got, want):
        np.testing.assert_array_equal(gl, tl)
        assert np.all(np.abs(gm - tm) <= 1e-5 * np.abs(tm))
        np.testing.assert_array_equal(gb, tb)


def _pairs(b, h, w):
    from scipy.ndimage import shift

    rng = np.random.default_rng(b)
    base = _textured(rng, (b, 3, h + 10, w + 10), k=5)
    im1 = base[..., 5:5 + h, 5:5 + w]
    im2 = np.stack([shift(x, (0, 0.5, -1.2), order=1)
                    for x in base])[..., 5:5 + h, 5:5 + w]
    wx = -1.0 + rng.normal(0, 0.3, (b, h, w))
    wy = np.full((b, h, w), 0.4)
    return [np.asarray(a, np.float32) for a in (wx, wy, im1, im2)]


@pytest.mark.cuda
def test_twoframe_batched_through_k5(cuda_device):
    args = _pairs(40, 64, 80)
    for params in (twoframe.TwoFrameParams(niter_outer=1),
                   twoframe.TwoFrameParams.sintel()):
        kernels.reset_launch_counts()
        gx, gy = twoframe.variational_twoframe_batched(*args, params,
                                                       device=cuda_device)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["sor"] == params.niter_outer \
            * params.niter_inner
        tx, ty = twoframe.variational_twoframe_batched(*args, params,
                                                       device="cpu")
        d = torch.hypot(gx.cpu() - tx, gy.cpu() - ty)
        if params.niter_outer == 1:
            assert float(d.max()) <= 1e-3
        else:
            assert float(d.median()) <= 1e-3 and float(d.mean()) <= 1e-2
