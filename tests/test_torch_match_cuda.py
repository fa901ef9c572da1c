"""The grid matcher's CUDA kernel (csrc/grid_match.cu) and the two-frame
solve's CUDA graph on the card.

- The kernel against its plain twin (`_best_displacement`, run on the same
  card) at radius 6, 32, 64 and 80 and B = 1 and 5, points on the grid and
  on the border: labels equal wherever the two displacements' float64
  costs differ by more than 1e-5 relative, and equal to the numpy model of
  the kernel's arithmetic (tests/match_model.py) everywhere; every block
  on the sentinel path for planes >= 0. Equal to the model everywhere on
  each of the kernel's paths: planes with negative values (the general
  tap loop, on the blocks whose patch holds one), patch radius 0, 2 and 6
  (the runtime-p instance), a search window larger than the image, a
  radius whose window takes dy in bands. The launch counter; two host
  threads launching on two streams at once, each equal to its own launch
  alone; bad inputs raise.
- `variational_twoframe_batched` through its CUDA graph bitwise equal to
  the eager solve (`_eager=True`) at B = 40 (K5's grouped path) and
  B = 1, with the second call replaying and capturing nothing.
Every test needs a CUDA GPU and skips without one.

    python -m pytest tests/test_torch_match_cuda.py -m cuda
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import pytest
import torch

import match_model
from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.epic import matching
from slowflow_tpu_torch.variational import graphs, twoframe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(rng, b, h, w):
    from scipy.ndimage import uniform_filter

    g1 = uniform_filter(rng.random((b, h + 6, w + 6)), size=(1, 3, 3))
    g2 = np.roll(g1, (2, -3), axis=(1, 2))
    return (g1[:, 3:3 + h, 3:3 + w].astype(np.float32),
            g2[:, 3:3 + h, 3:3 + w].astype(np.float32))


def _points(b, h, w, step):
    ys, xs = np.mgrid[step // 2:h:step, step // 2:w:step]
    ys = np.concatenate([ys.ravel(), [0, 0, h - 1, h - 1, h // 2]])
    xs = np.concatenate([xs.ravel(), [0, w - 1, 0, w - 1, w - 1]])
    return (np.broadcast_to(ys, (b, len(ys))).copy(),
            np.broadcast_to(xs, (b, len(xs))).copy())


def _kernel(dev, g1, g2, ys, xs, radius, patch_r=4):
    t = [torch.tensor(a, device=dev) for a in (g1, g2, ys, xs)]
    out = matching.grid_match(*t, radius, patch_r)
    torch.cuda.synchronize()
    return out.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("radius, h, w, step", [
    (6, 37, 53, 8), (32, 70, 90, 16), (64, 100, 140, 30), (80, 120, 170, 40)])
def test_kernel_matches_twin_and_model(cuda_device, radius, h, w, step, b):
    g1, g2 = _planes(np.random.default_rng(radius + b), b, h, w)
    ys, xs = _points(b, h, w, step)
    kernels.reset_launch_counts()
    matching.grid_match_paths()
    got = _kernel(cuda_device, g1, g2, ys, xs, radius)
    assert kernels.LAUNCHES["grid_match"] == 1
    assert matching.grid_match_paths() == {"sentinel": ys.size, "general": 0}
    twin = matching._best_displacement(
        *(torch.tensor(a, device=cuda_device) for a in (g1, g2, ys, xs)),
        radius, 4).cpu().numpy()
    ties = match_model.differ_only_on_ties(g1, g2, ys, xs, got, twin,
                                           radius, 4)
    assert all(ok for _, ok in ties), ties
    if radius <= 64:
        model = match_model.best_displacement(g1, g2, ys, xs, radius, 4)
        np.testing.assert_array_equal(got, model)


@pytest.mark.cuda
@pytest.mark.parametrize("negative", [False, True])
def test_kernel_takes_dy_in_bands(cuda_device, negative):
    out = (ctypes.c_longlong * 6)()
    kernels.check(kernels.load().sf_grid_match_plan(150, 300, 120, 4, out),
                  "plan")
    assert out[1] > 1                      # bands
    g1, g2 = _planes(np.random.default_rng(7), 1, 150, 300)
    if negative:
        g1 -= 0.5
    ys, xs = _points(1, 150, 300, 75)
    got = _kernel(cuda_device, g1, g2, ys, xs, 120)
    twin = matching._best_displacement(
        *(torch.tensor(a, device=cuda_device) for a in (g1, g2, ys, xs)),
        120, 4).cpu().numpy()
    ties = match_model.differ_only_on_ties(g1, g2, ys, xs, got, twin, 120, 4)
    assert all(ok for _, ok in ties), ties
    np.testing.assert_array_equal(
        got, match_model.best_displacement(g1, g2, ys, xs, 120, 4))


def _general_blocks(g1, ys, xs, patch_r):
    """Points whose in-image patch of g1 holds a value < 0 (or NaN)."""
    b, h, w = g1.shape
    n = 0
    for bi in range(b):
        for y, x in zip(ys[bi], xs[bi]):
            patch = g1[bi, max(0, y - patch_r):y + patch_r + 1,
                       max(0, x - patch_r):x + patch_r + 1]
            n += int(not (patch >= 0).all())
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("patch_r", [4, 2])
def test_general_path_on_negative_planes(cuda_device, patch_r):
    """Negative values in the top half of g1: the blocks whose patch holds
    one take the general tap loop, the others the sentinel path; labels
    equal the model's everywhere."""
    b, h, w, radius = 2, 41, 57, 9
    g1, g2 = _planes(np.random.default_rng(11), b, h, w)
    g1[:, :h // 2] -= 0.5
    g2[:, h // 3:] -= 0.25
    ys, xs = _points(b, h, w, 6)
    matching.grid_match_paths()
    got = _kernel(cuda_device, g1, g2, ys, xs, radius, patch_r)
    general = _general_blocks(g1, ys, xs, patch_r)
    assert 0 < general < ys.size
    assert matching.grid_match_paths() == {"sentinel": ys.size - general,
                                           "general": general}
    np.testing.assert_array_equal(
        got, match_model.best_displacement(g1, g2, ys, xs, radius, patch_r))


@pytest.mark.cuda
@pytest.mark.parametrize("h, w, radius, step, patch_r", [
    (48, 70, 12, 7, 0), (48, 70, 12, 7, 2), (48, 70, 12, 7, 6),  # runtime p
    (23, 35, 40, 5, 4), (23, 35, 40, 5, 1)])  # window larger than the image
def test_kernel_equals_model(cuda_device, h, w, radius, step, patch_r):
    g1, g2 = _planes(np.random.default_rng(radius + patch_r), 2, h, w)
    ys, xs = _points(2, h, w, step)
    got = _kernel(cuda_device, g1, g2, ys, xs, radius, patch_r)
    np.testing.assert_array_equal(
        got, match_model.best_displacement(g1, g2, ys, xs, radius, patch_r))


@pytest.mark.cuda
def test_flat_planes_take_the_first_index(cuda_device):
    g = np.full((2, 40, 50), 0.25, np.float32)
    ys, xs = _points(2, 40, 50, 9)
    got = _kernel(cuda_device, g, g, ys, xs, 10)
    np.testing.assert_array_equal(
        got, match_model.best_displacement(g, g, ys, xs, 10, 4))


@pytest.mark.cuda
def test_two_threads_on_two_streams(cuda_device):
    cases = []
    for seed in (1, 2):
        g1, g2 = _planes(np.random.default_rng(seed), 4, 90, 120)
        ys, xs = _points(4, 90, 120, 10)
        cases.append([torch.tensor(a, device=cuda_device)
                      for a in (g1, g2, ys, xs)])
    want = [matching.grid_match(*c, 24, 4).cpu() for c in cases]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def work(i):
        try:
            stream = torch.cuda.Stream(cuda_device)
            stream.wait_stream(torch.cuda.default_stream(cuda_device))
            start.wait()
            with torch.cuda.stream(stream):
                outs = [matching.grid_match(*cases[i], 24, 4)
                        for _ in range(3)]
            stream.synchronize()
            got[i] = [o.cpu() for o in outs]
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for i in (0, 1):
        for g in got[i]:
            assert torch.equal(g, want[i])


@pytest.mark.cuda
def test_bad_inputs_raise(cuda_device):
    g = torch.zeros((1, 20, 20), device=cuda_device)
    ys = torch.zeros((1, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int64"):
        matching.grid_match(g, g, ys.int(), ys, 4, 4)
    strided = torch.zeros((1, 6), dtype=torch.int64,
                          device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        matching.grid_match(g, g, strided, ys, 4, 4)
    with pytest.raises(TypeError):
        matching.grid_match(g.double(), g, ys, ys, 4, 4)
    with pytest.raises(ValueError, match="radius"):
        matching.grid_match(g, g, ys, ys, -1, 4)


def _pairs(b, h, w, seed=0):
    from scipy.ndimage import shift, uniform_filter

    rng = np.random.default_rng(seed)
    base = uniform_filter(rng.random((b, 3, h + 10, w + 10)) * 255,
                          size=(1, 1, 5, 5))
    im1 = base[..., 5:5 + h, 5:5 + w]
    im2 = np.stack([shift(x, (0, 0.5, -1.2), order=1)
                    for x in base])[..., 5:5 + h, 5:5 + w]
    wx = -1.0 + rng.normal(0, 0.3, (b, h, w))
    wy = np.full((b, h, w), 0.4)
    return [np.asarray(a, np.float32) for a in (wx, wy, im1, im2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, w", [(40, 270, 480), (1, 270, 480)])
def test_twoframe_graph_equals_eager(cuda_device, b, h, w):
    graphs.clear()
    args = [torch.tensor(a, device=cuda_device) for a in _pairs(b, h, w)]
    p = twoframe.TwoFrameParams.sintel()
    want = twoframe.variational_twoframe_batched(*args, p, _eager=True)
    graphs.reset_stats()
    kernels.reset_launch_counts()
    first = twoframe.variational_twoframe_batched(*args, p)
    assert graphs.STATS["captures"] == 1
    assert kernels.LAUNCHES["sor"] == p.niter_outer * p.niter_inner
    second = twoframe.variational_twoframe_batched(*args, p)
    torch.cuda.synchronize()
    assert graphs.STATS["captures"] == 1 and graphs.STATS["replays"] == 1
    assert kernels.LAUNCHES["sor"] == 2 * p.niter_outer * p.niter_inner
    for got in (first, second):
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    assert twoframe.twoframe_key(args[0].device, p, b, h, w) \
        in graphs.cached_keys()
    graphs.clear()
