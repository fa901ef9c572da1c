"""The port's two-frame variational refinement against the JAX package's
`slowflow_tpu.variational.twoframe`, on the CPU (where the SOR step is K5's
plain twin, the function the JAX version calls).

The building blocks within 1e-5 of the plane max; one outer iteration
within 1e-4 px max; the sintel preset (5 outer iterations) within 3x the
JAX package's own spread under a 1e-7 relative input perturbation (median,
90th percentile and mean of |dflow|, plus 1e-4 px), as
tests/test_torch_slice.py measures it; the batched entry equal to the
single one; the presets field by field. The graph form (the solve as one
segment over `graphs.Slots`, run without capture as a replay would run it,
three times over the same Slots) bitwise the eager `_refine` at B = 1 and 3
with two presets; the cache key tells params, batch, size and device
apart; the CPU never captures. Inputs come from a seeded numpy
generator. The JAX warp takes its exact (non-banded) path at these sizes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slowflow_tpu.variational import twoframe as jtf
from slowflow_tpu_torch.variational import graphs
from slowflow_tpu_torch.variational import twoframe as ttf
from test_torch_stage3_graphs import _Uncaptured, graph_form

H, W = 40, 52


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(b=1, seed=0, h=H, w=W):
    """Smooth textures moved by (-1.2, 0.5) px, and a rough initial flow."""
    from scipy.ndimage import shift, uniform_filter

    rng = np.random.default_rng(seed)
    im1s, im2s = [], []
    for _ in range(b):
        base = np.stack([uniform_filter(c, 5) for c in
                         rng.random((3, h + 10, w + 10)) * 255])
        im1s.append(base[:, 5:5 + h, 5:5 + w])
        im2s.append(np.stack([shift(c, (0.5, -1.2), order=1)
                              for c in base])[:, 5:5 + h, 5:5 + w])
    wx = (-1.0 + rng.normal(0, 0.3, (b, h, w))).astype(np.float32)
    wy = np.full((b, h, w), 0.4, np.float32)
    return (wx, wy, np.asarray(im1s, np.float32),
            np.asarray(im2s, np.float32))


def _jax(wx, wy, im1, im2, params):
    out = jtf.variational_twoframe_batched(
        jnp.asarray(wx), jnp.asarray(wy), jnp.asarray(im1), jnp.asarray(im2),
        params)
    return [np.asarray(o) for o in out]


def _port(wx, wy, im1, im2, params):
    out = ttf.variational_twoframe_batched(
        wx, wy, im1, im2, ttf.TwoFrameParams(**dataclasses.asdict(params)),
        device="cpu")
    return [o.numpy() for o in out]


def test_building_blocks_match_jax():
    wx, wy, im1, im2 = _pair()
    rng = np.random.default_rng(1)
    w_im2 = im2[0] + rng.normal(0, 2, im2[0].shape).astype(np.float32)
    jd = jtf.get_derivatives(jnp.asarray(im1[0]), jnp.asarray(w_im2))
    td = ttf.get_derivatives(torch.tensor(im1[0]), torch.tensor(w_im2))
    for a, b in zip(td, jd):
        assert _rel(a.numpy(), b) <= 1e-5
    jdp = jtf.compute_dpsis_weight(jnp.asarray(im1[0]))
    tdp = ttf.compute_dpsis_weight(torch.tensor(im1[0]))
    assert _rel(tdp.numpy(), jdp) <= 1e-5
    jw = jtf.compute_smoothness(jnp.asarray(wx[0]), jnp.asarray(wy[0]), jdp,
                                0.5)
    tw = ttf.compute_smoothness(torch.tensor(wx[0]), torch.tensor(wy[0]),
                                tdp, 0.5)
    for a, b in zip(tw, jw):
        assert _rel(a.numpy(), b) <= 1e-5
    du, dv = rng.normal(0, 0.2, (2, H, W)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.1).astype(np.float32)
    for delta in (0.0, 1.0):
        ja = jtf.compute_data_and_match(
            jnp.asarray(du), jnp.asarray(dv), jnp.asarray(mask), jd,
            delta * 0.5 / 3, 0.72 * 0.5 / 3)
        ta = ttf.compute_data_and_match(
            torch.tensor(du), torch.tensor(dv), torch.tensor(mask), td,
            delta * 0.5 / 3, 0.72 * 0.5 / 3)
        for a, b in zip(ta, ja):
            assert _rel(a.numpy(), b) <= 1e-5
    jl = jtf.sub_laplacian(jnp.asarray(du), jnp.asarray(wx[0]), *jw)
    tl = ttf.sub_laplacian(torch.tensor(du), torch.tensor(wx[0]), *tw)
    assert _rel(tl.numpy(), jl) <= 1e-5


@pytest.mark.parametrize("delta", [0.0, 1.0])
def test_one_outer_iteration_matches_jax(delta):
    args = _pair(b=2)
    p = jtf.TwoFrameParams(niter_outer=1, delta=delta)
    (jwx, jwy), (twx, twy) = _jax(*args, p), _port(*args, p)
    assert max(np.abs(twx - jwx).max(), np.abs(twy - jwy).max()) <= 1e-4


def test_sintel_preset_within_jax_self_spread():
    wx, wy, im1, im2 = _pair(b=2, seed=3)
    p = jtf.TwoFrameParams.sintel()
    rng = np.random.default_rng(99)
    noisy = (im1 * (1 + 1e-7 * rng.standard_normal(im1.shape))
             ).astype(np.float32)
    jwx, jwy = _jax(wx, wy, im1, im2, p)
    nwx, nwy = _jax(wx, wy, noisy, im2, p)
    twx, twy = _port(wx, wy, im1, im2, p)
    d = np.hypot(twx - jwx, twy - jwy)
    s = np.hypot(nwx - jwx, nwy - jwy)
    for q in (0.5, 0.9):
        assert np.quantile(d, q) <= 3 * np.quantile(s, q) + 1e-4
    assert d.mean() <= 3 * s.mean() + 1e-4
    # and it moved the flow towards the true (-1.2, 0.5)
    inner = (slice(None), slice(8, -8), slice(8, -8))
    assert abs(np.median(twx[inner]) + 1.2) < 0.1
    assert abs(np.median(twy[inner]) - 0.5) < 0.1


def test_single_pair_entry_equals_batched():
    wx, wy, im1, im2 = _pair(b=2, seed=4)
    p = ttf.TwoFrameParams(niter_outer=2, niter_inner=2)
    bx, by = ttf.variational_twoframe_batched(wx, wy, im1, im2, p,
                                              device="cpu")
    for i in range(2):
        sx, sy = ttf.variational_twoframe(wx[i], wy[i], im1[i], im2[i], p,
                                          device="cpu")
        torch.testing.assert_close(sx, bx[i], rtol=0, atol=1e-6)
        torch.testing.assert_close(sy, by[i], rtol=0, atol=1e-6)


def test_presets_match_jax():
    for name in ("sintel", "kitti", "middlebury"):
        assert dataclasses.asdict(getattr(ttf.TwoFrameParams, name)()) == \
            dataclasses.asdict(getattr(jtf.TwoFrameParams, name)())
    assert dataclasses.asdict(ttf.TwoFrameParams()) == \
        dataclasses.asdict(jtf.TwoFrameParams())


# ------------------------------------------------------- the graph form
@pytest.mark.parametrize("preset", ["sintel", "kitti"])
@pytest.mark.parametrize("b", [1, 3])
def test_graph_form_equals_eager(b, preset):
    """The solve as one segment over Slots, run three times over the same
    Slots (as replays reuse them) on two inputs: bitwise the eager
    `_refine` each time, and a fresh copy returned each time."""
    p = getattr(ttf.TwoFrameParams, preset)()
    pairs = [[torch.tensor(a) for a in _pair(b=b, seed=s)] for s in (5, 6)]
    want = [ttf._refine(*args, p) for args in pairs]
    with graph_form() as progs:
        outs = [ttf.variational_twoframe_batched(*pairs[i], p, device="cpu")
                for i in (0, 1, 0)]
    (key, prog), = progs.items()
    assert key == ttf.twoframe_key("cpu", p, b, H, W)
    assert prog.segments == [("refine",)] * 3
    for got, i in zip(outs, (0, 1, 0)):
        for g, w in zip(got, want[i]):
            assert torch.equal(g, w)
    assert outs[0][0] is not outs[2][0]
    assert outs[0][0].data_ptr() != prog.state.wx.data_ptr()


def test_graph_form_without_outer_iterations_copies_the_input():
    """niter_outer = 0 leaves the flow as it came, in the state's own
    memory."""
    wx, wy, im1, im2 = (torch.tensor(a) for a in _pair(b=2))
    p = ttf.TwoFrameParams(niter_outer=0)
    prog = _Uncaptured()
    gx, gy = ttf._refine_program(prog, wx, wy, im1, im2, p)
    assert torch.equal(gx, wx) and torch.equal(gy, wy)
    assert gx.data_ptr() != wx.data_ptr() != prog.inputs.wx.data_ptr()


def _other(value):
    return value + 1 if isinstance(value, int) else value * 1.5 + 0.25


def test_cache_key_tells_inputs_apart():
    p = ttf.TwoFrameParams.sintel()
    key = ttf.twoframe_key("cuda:0", p, 40, 270, 480)
    assert key == ttf.twoframe_key(torch.device("cuda:0"),
                                   dataclasses.replace(p), 40, 270, 480)
    for f in dataclasses.fields(p):
        q = dataclasses.replace(p, **{f.name: _other(getattr(p, f.name))})
        assert ttf.twoframe_key("cuda:0", q, 40, 270, 480) != key, f.name
    for args in (("cuda:1", p, 40, 270, 480), ("cuda:0", p, 1, 270, 480),
                 ("cuda:0", p, 40, 271, 480), ("cuda:0", p, 40, 270, 481),
                 ("cpu", p, 40, 270, 480)):
        assert ttf.twoframe_key(*args) != key


def test_cpu_never_captures():
    graphs.clear()
    graphs.reset_stats()
    wx, wy, im1, im2 = _pair(b=2)
    got = ttf.variational_twoframe_batched(
        wx, wy, im1, im2, ttf.TwoFrameParams(niter_outer=1), device="cpu")
    want = ttf._refine(*(torch.tensor(a) for a in (wx, wy, im1, im2)),
                       ttf.TwoFrameParams(niter_outer=1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert graphs.STATS == {"captures": 0, "replays": 0, "capture_s": 0.0}
    assert graphs.cached_keys() == []


def test_batched_entry_takes_three_dims():
    wx, wy, im1, im2 = _pair(b=1)
    with pytest.raises(ValueError, match="B, H, W"):
        ttf.variational_twoframe_batched(wx[0], wy[0], im1[0], im2[0],
                                         device="cpu")
