"""The EPIC layer and the two-frame solve on the card against the same
functions on the CPU, at odd sizes and batches of 1 and 5: the stage-2
preprocess (Lab, saliency, edges) within 1e-5 of the plane max; the grid
matcher's kept matches row for row on textured pairs; the distance
transform's distances within 1e-5 relative with identical labels; and
`variational_twoframe_batched` at B = 40, 64x80 through K5 (the CPU side is
K5's plain twin): one outer iteration within 1e-3 px max, the sintel preset
with a median |dflow| <= 1e-3 px and a mean <= 1e-2 px (nvcc's FMA
contraction, amplified by the robust weights over five warps); the LA fit
and apply kernels (csrc/epic_fit.cu) against their numpy twins at stage 3's
shape, on ragged jobs, short rows and a singular seed; `epic_batched` at
stage 1's and stage 3's shapes and the stage-2 CLI's EPIC inits with two
init workers against the CPU. Every test needs a CUDA GPU and skips
without one.

    python -m pytest tests/test_torch_epic_cuda.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.cli import slow_flow
from slowflow_tpu_torch.epic import distance, interp, matching
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


def _la_jobs(case, rng):
    """Locally-affine problems as EPIC makes them: per job, seeds on every
    second point of a 270x480 grid (a share dropped), the k-NN table of
    the seed graph (each seed's nearest seeds, itself first; -1 / +inf for
    the tail of a row cut short; distances growing with the offset), each
    seed's table row (~1 % share a neighbour's pixel, and so its row) and
    distance at its pixel, a smooth flow with noise. Returns (jobs of
    (nnf, dis, rows, d0, seeds, vects), h, w)."""
    h, w = 270, 480
    gy, gx = np.mgrid[0:h:2, 0:w:2]
    if case == "stage3":
        sizes, k = [32400] * 6 + [31000, 29500, 28000, 30500], 160
    elif case == "ragged":
        sizes, k = [3000, 1, 517], 160
    else:
        sizes, k = [4000, 2500], 160
    jobs = []
    for ns in sizes:
        cells = np.sort(rng.choice(gy.size, ns, replace=False))
        lookup = np.full(gy.shape, -1, np.int32)
        lookup.ravel()[cells] = np.arange(ns)
        cy, cx = np.unravel_index(cells, gy.shape)
        # a window that holds ~1.5 k seeds at this density, nearest first
        r = int(np.sqrt(1.5 * k * gy.size / (np.pi * ns))) + 2
        oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
        order = np.argsort(np.hypot(oy, ox).ravel(), kind="stable")
        off = np.stack([oy.ravel()[order], ox.ravel()[order]], 1)
        ny = cy[:, None] + off[None, :, 0]
        nx = cx[:, None] + off[None, :, 1]
        inside = (ny >= 0) & (ny < gy.shape[0]) & (nx >= 0) \
            & (nx < gy.shape[1])
        cand = np.where(inside, lookup[ny.clip(0, gy.shape[0] - 1),
                                       nx.clip(0, gy.shape[1] - 1)], -1)
        kk = min(k, ns)
        keep = np.argsort(cand < 0, axis=1, kind="stable")[:, :kk]
        nnf = np.take_along_axis(cand, keep, 1)
        # geodesic: ~0.05 a pixel (the edge cost of smooth texture)
        dist = 0.1 * np.hypot(*off.T)[keep] \
            * (1 + 0.5 * rng.random((ns, kk))) + 0.05 * rng.random((ns, 1))
        if ns == 1:
            # its fit has only the stabilizers' spread (condition ~1e14):
            # a weight one ulp off moves it by ~5e-6 relative, and numpy's
            # float32 exp and CUDA's expf each round within 2 ulp; at
            # distance 0 both weigh exactly 1
            dist[:] = 0.0
        if case == "unfilled":
            cut = rng.random(ns) < 0.2
            nnf[cut, kk // 3:] = -1
        dis = np.where(nnf >= 0, dist, np.inf).astype(np.float32)
        rows = np.arange(ns)
        shared = (rng.random(ns) < 0.01) & (nnf[:, -1] >= 0)
        rows[shared] = nnf[shared, -1]
        d0 = (0.05 * rng.random(ns) * (ns > 1)).astype(np.float32)
        seeds = np.stack([gx.ravel()[cells], gy.ravel()[cells]], 1)
        vects = np.stack([1.5 + 0.01 * seeds[:, 0], -0.8 + 0.02 * seeds[:, 1]],
                         1) + rng.normal(0, 0.3, (ns, 2))
        jobs.append((nnf.astype(np.int32), dis, rows, d0,
                     seeds.astype(np.float32), vects.astype(np.float32)))
    if case == "singular":
        # seed 0's row holds seed 1 alone, 256 times, at (512, 256) with
        # weight 1: P x^2, P y^2 >= 2^24 swallow the 1e-9 ridge and the
        # elimination meets an exact zero in the second column; seeds 1-9,
        # a 3x3 block 8 px apart around it, are well posed
        pts = [(500, 250)] + [(512 + 8 * a, 256 + 8 * b)
                              for b in range(3) for a in range(3)]
        nnf = np.full((10, 256), -1, np.int32)
        nnf[0] = 1
        for i in range(1, 10):
            nnf[i, :9] = [i] + [j for j in range(1, 10) if j != i]
        dis = np.where(nnf >= 0, 0.5 + 2 * rng.random((10, 256)), np.inf)
        dis[0] = 0.0
        dis[np.arange(1, 10), 0] = 0.1
        vects = rng.normal(0, 2, (10, 2))
        jobs.append((nnf, dis.astype(np.float32), np.arange(10),
                     np.zeros(10, np.float32), np.float32(pts),
                     vects.astype(np.float32)))
    return jobs, h, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stage3", "ragged", "unfilled",
                                  "singular"])
def test_la_kernels_match_twin(cuda_device, case):
    """The fit and apply kernels (csrc/epic_fit.cu) against the numpy twin
    `_kernelize` -> `fit_localaffine` -> `apply_localaffine`, job by job:
    the affine rows within 1e-5 relative (the twin's bound against the JAX
    package), the apply bitwise the twin's on the kernel's rows, and the
    flows within 1e-3 px of the twin's (a flow a x + b y + c - x cancels
    most of its terms: 1e-7 of the rows' largest entry is ~1e-4 px), or
    within 1e-5 of the largest flow where that is more (the one-seed job's
    map, fitted to its stabilizers alone, sends flows to ~1e4 px). At
    stage 3's shape (10 jobs of ~32 k seeds, nn 160), ragged jobs (one of
    a single seed), rows cut short, and a job whose seed 0 has a singular
    system, which the kernel's least squares solves (the twin falls back
    to numpy's lstsq for the whole job); an empty call."""
    rng = np.random.default_rng(19)
    jobs, h, w = _la_jobs(case, rng)
    labels = [rng.integers(-1, len(j[0]), (h, w)) for j in jobs]
    kernels.reset_launch_counts()
    fallback = interp.FIT_FALLBACK_SEEDS
    with torch.cuda.device(cuda_device):
        t = interp.pack_jobs(*([j[i] for j in jobs] for i in range(6)),
                             cuda_device)
        affine = interp.fit_localaffine_cuda(*t, 1.1)
        flows = interp.apply_localaffine_cuda(
            affine, torch.as_tensor(np.stack(labels).astype(np.int32),
                                    device=cuda_device), t[-1][:-1])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["epic_fit"] == kernels.LAUNCHES["epic_apply"] == 1
    assert interp.FIT_FALLBACK_SEEDS - fallback == (case == "singular")
    affine, flows = affine.cpu().numpy(), flows.cpu().numpy()
    for b, (nnf, dis, rows, d0, seeds, vects) in enumerate(jobs):
        # dist_trf_nnfield_batched's gather, then the twin
        want = interp.fit_localaffine(
            nnf[rows], interp._kernelize(d0[:, None] + dis[rows], 1.1),
            seeds, vects)
        mine = affine[int(t[-1][b]):int(t[-1][b + 1])]
        assert _rel(torch.as_tensor(mine), torch.as_tensor(want)) <= 1e-5, b
        np.testing.assert_array_equal(
            flows[b], interp.apply_localaffine(mine, labels[b], h, w))
        flow = interp.apply_localaffine(want, labels[b], h, w)
        assert np.abs(flows[b] - flow).max() \
            <= max(1e-3, 1e-5 * np.abs(flow).max()), b
    if case == "ragged":
        nnf = t[2].clone()
        nnf[int(t[4][0]), 1] = len(jobs[0][0])  # one past job 0's last seed
        with torch.cuda.device(cuda_device), \
                pytest.raises(ValueError, match="beyond"):
            interp.fit_localaffine_cuda(t[0], t[1], nnf, *t[3:], 1.1)
        # no seed at all: an empty result, its counts zeroed all the same
        none = [x[:0] for x in t[:-1]] + [t[-1][:1] * 0]
        with torch.cuda.device(cuda_device):
            assert interp.fit_localaffine_cuda(*none, 1.1).shape == (0, 6)


def _epic_call(stage, rng):
    """An `epic_batched` call as stage 1 makes it (4 pairs at 270x480,
    matches every 8 px) or stage 3 (10 jets at 270x480, a match on every
    second point, saliency given): Lab and edges of a textured image, a
    smooth flow with noise and a few gross outliers."""
    from slowflow_tpu_torch.core.image import rgb_to_lab, saliency
    from slowflow_tpu_torch.epic.edges import detect_edges

    h, w = 270, 480
    b, step = (4, 8) if stage == 1 else (10, 2)
    rgb = torch.as_tensor(_textured(rng, (3, h, w), k=7), dtype=torch.float32)
    lab = rgb_to_lab(rgb).numpy()
    edges = detect_edges(rgb).numpy()
    sal = saliency(torch.as_tensor(lab), 0.8, 1.0).numpy() \
        if stage == 3 else None
    ys, xs = np.mgrid[step // 2:h:step, step // 2:w:step]
    pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    jobs = []
    for j in range(b):
        flow = np.stack([1.5 + 0.004 * pts[:, 0] + 0.3 * j,
                         -0.8 + 0.006 * pts[:, 1]], 1)
        m = np.concatenate([pts, pts + flow + rng.normal(0, 0.2, pts.shape)],
                           1).astype(np.float32)
        m[rng.random(len(m)) < 0.01, 2] += 15.0
        jobs.append((lab, m, edges, sal))
    return jobs


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 3])
def test_epic_batched_la_on_the_card(cuda_device, stage):
    """`epic_batched` (sintel preset, LA) on the card, where the fits are
    one launch of each kernel, against the same call on the CPU: a median
    |dflow| <= 1e-4 px and >= 99.9 % of pixels within 1e-3 px, the bound of
    the CPU path against the JAX package (the card's distance transform
    agrees with the CPU's within 1e-5 relative, not bitwise)."""
    jobs = _epic_call(stage, np.random.default_rng(stage))
    params = interp.EpicParams.sintel()
    kernels.reset_launch_counts()
    fallback = interp.FIT_FALLBACK_SEEDS
    got = interp.epic_batched(jobs, params, device=cuda_device)
    assert kernels.LAUNCHES["epic_fit"] == kernels.LAUNCHES["epic_apply"] == 1
    assert interp.FIT_FALLBACK_SEEDS == fallback
    want = interp.epic_batched(jobs, params, device="cpu")
    for g, t in zip(got, want):
        d = np.abs(g - t)
        assert np.abs(t).max() > 0.5
        assert np.median(d) <= 1e-4 and (d <= 1e-3).mean() >= 0.999


def _stage2_sequence(seq_dir, h=72, w=96, n=12, u=1.0, v=0.5):
    """Smooth random texture translating at (u, v) px/frame (8-bit PNGs)."""
    from scipy.ndimage import map_coordinates

    from slowflow_tpu_torch.io import write_image

    base = _textured(np.random.default_rng(7), (3, h + 80, w + 80), k=7)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    seq_dir.mkdir(parents=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for f in range(n):
        img = np.stack([map_coordinates(c, [yy + 40 - f * v, xx + 40 - f * u],
                                        order=1) for c in base], -1)
        write_image(seq_dir / f"frame_{f:03d}.png", img)
    (seq_dir / "quantil.dat").write_text("1.1\n2.0\n")


@pytest.mark.cuda
def test_stage2_epic_init_workers_on_the_card(cuda_device, tmp_path):
    """The stage-2 CLI with `deep_matching 1` and two init workers on the
    card: the workers' `epic_batched` calls launch the fit kernels on their
    own stream beside the level graphs' capture and replays; the EPIC inits
    handed to the solve agree with the CLI's on the CPU (`-device cpu`) at
    the `epic_batched` bound above."""
    from unittest import mock

    _stage2_sequence(tmp_path / "seq")
    inits = {}
    for dev in ("cuda", "cpu"):
        cfg = tmp_path / f"{dev}.cfg"
        cfg.write_text("\n".join("\t".join(kv) for kv in (
            ("file", f"{tmp_path}/seq/frame_%03i.png"),
            ("output", f"{tmp_path}/out_{dev}"), ("Jets", "2"),
            ("start", "2"), ("max_fps", "40"), ("ref_fps", "20"),
            ("jet_fps", "40"), ("adaptive", "0"), ("16bit", "0"),
            ("raw", "0"), ("scale", "1.0"), ("deep_matching", "1"),
            ("slow_flow_S", "2"), ("slow_flow_layers", "2"),
            ("slow_flow_p_scale", "0.8"),
            ("slow_flow_occlusion_reasoning", "1"),
            ("slow_flow_niter_alter", "2"), ("slow_flow_niter_outer", "4"),
            ("slow_flow_niter_solver", "20"))) + "\n")
        kernels.reset_launch_counts()
        with mock.patch.object(slow_flow, "variational_mt_batched",
                               wraps=slow_flow.variational_mt_batched) as sv:
            assert slow_flow.main([str(cfg), "-batch", "2", "-threads", "2",
                                   "-device", dev]) == 0
        inits[dev] = [np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                 else a) for c in sv.call_args_list
                      for a in c.args[:2]]
        if dev == "cuda":
            calls = len(sv.call_args_list)
            assert calls == 2
            assert kernels.LAUNCHES["epic_fit"] == calls
            assert kernels.LAUNCHES["epic_apply"] == calls
    assert len(inits["cuda"]) == len(inits["cpu"]) == 4
    for a, b in zip(inits["cuda"], inits["cpu"]):
        assert np.abs(b).max() > 0.3
        d = np.abs(a - b)
        assert np.median(d) <= 1e-4 and (d <= 1e-3).mean() >= 0.999
