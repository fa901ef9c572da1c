"""The stack, unfused and composed routes of the port against the JAX package.

The plain twins of K3 (fused_data_system_ref), K4 (warp_stack_ref), K5
(sor_coupled_rb, the CPU side of sor_coupled_rb_pallas) and K6's entries
(warp_stack_pallas_ref, warp_bilinear_pallas) are held to the JAX package's
XLA functions (get_derivatives_mt + add_data_terms / occlusion_data_costs,
the non-banded warp_bilinear, sor_coupled_rb) on numpy inputs from a seed;
tolerances are relative to the largest |value| of the JAX plane (float32
sums in another order), masks identical. The route resolver is held to the
JAX package's branch conditions. Tests marked `cuda` hold the kernels to
their twins and need a GPU.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slowflow_tpu.core import solver as jsolver
from slowflow_tpu.core import warp as jwarp
from slowflow_tpu.variational import multiframe as jmf
from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.core import solver_pallas, warp_pallas, warp_shift
from slowflow_tpu_torch.variational import fused_data, fused_warp, terms
from slowflow_tpu_torch.variational.params import (MultiFrameParams, Route,
                                                   from_jax_params)

B, H, W, REF = 2, 40, 56, 2
F = 2 * REF + 1


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flow(rng, b, h, w, scale=1.5, mean=(0.7, -0.4)):
    coarse = rng.normal(0, 1, (b, 2, h // 8 + 2, w // 8 + 2))
    flow = np.kron(coarse, np.ones((8, 8)))[..., :h, :w] * scale
    return ((flow[:, 0] + mean[0]).astype(np.float32),
            (flow[:, 1] + mean[1]).astype(np.float32))


def _jax_warp(seq, wx, wy, ref):
    """The JAX package's non-banded warp of every frame (ref passes)."""
    warped, masks = [], []
    for k in range(seq.shape[0]):
        if k == ref:
            warped.append(np.asarray(seq[k]))
            masks.append(np.ones(wx.shape, np.float32))
            continue
        o, m = jwarp.warp_bilinear(jnp.asarray(seq[k]), jnp.asarray(wx),
                                   jnp.asarray(wy), factor=float(k - ref),
                                   banded=False)
        warped.append(np.asarray(o))
        masks.append(np.asarray(m))
    return np.stack(warped), np.stack(masks)


@pytest.fixture(scope="module")
def window():
    """A batch of windows, their JAX warp and derivative stacks."""
    rng = np.random.default_rng(0)
    seq = (rng.random((B, F, 3, H, W)) * 255).astype(np.float32)
    wx, wy = _flow(rng, B, H, W)
    du = (rng.random((B, H, W)) * 0.3).astype(np.float32)
    dv = (rng.random((B, H, W)) * 0.2).astype(np.float32)
    cw = (rng.random((B, 3, H, W)) + 0.5).astype(np.float32)
    gate = (rng.random((B, 2 * REF, H, W)) > 0.3).astype(np.float32)
    warped = np.stack([_jax_warp(seq[i], wx[i], wy[i], REF)[0]
                       for i in range(B)])
    stacks = [jmf.get_derivatives_mt(jnp.asarray(seq[i]), jnp.asarray(wx[i]),
                                     jnp.asarray(wy[i]), REF,
                                     warp_mode="banded") for i in range(B)]
    mask = np.stack([np.asarray(m) for _, _, m in stacks])
    return dict(seq=seq, wx=wx, wy=wy, du=du, dv=dv, cw=cw, gate=gate,
                warped=warped, stacks=stacks, mask=mask)


def _params(**kwargs):
    return jmf.MultiFrameParams(S=3, rho=(1.0, 0.8), omega=(0.5, 2.0),
                                layers=1, smoothing=1,
                                occlusion_reasoning=True, **kwargs)


def _jax_per_jet(fn, n):
    outs = [fn(i) for i in range(n)]
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]


def _t(*arrays):
    return [torch.tensor(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------------- K3
@pytest.mark.parametrize("kwargs,zero_duv", [
    (dict(), False),
    (dict(), True),
    (dict(dataterm_norm=False, one_direction=True), False),
    (dict(delta=0.0), False),
    (dict(gamma=0.0), False),
])
def test_fused_data_ref_assembly(window, kwargs, zero_duv):
    """K3's twin in `assembly` mode, given a gated mask, against
    get_derivatives_mt + add_data_terms: 1e-5 of each plane's max."""
    jp = _params(**kwargs)
    d = window
    du, dv = (np.zeros_like(d["du"]),) * 2 if zero_duv else (d["du"], d["dv"])
    gm = (d["mask"] * d["gate"]).astype(np.float32)

    def one(i):
        succ, to_ref, _ = d["stacks"][i]
        return jmf.add_data_terms(jnp.asarray(du[i]), jnp.asarray(dv[i]),
                                  jnp.asarray(gm[i]), succ, to_ref,
                                  jnp.asarray(d["cw"][i]), jp)

    want = _jax_per_jet(one, B)
    got = fused_data.fused_data_system(
        *_t(d["warped"], gm, du, dv, d["cw"]), from_jax_params(jp),
        mode="assembly", zero_duv=zero_duv)
    assert len(got) == 5
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-5


def test_fused_data_ref_occ(window):
    """K3's twin in `occ` mode, given the raw mask, against
    occlusion_data_costs."""
    jp = _params()
    d = window

    def one(i):
        succ, to_ref, mask = d["stacks"][i]
        return jmf.occlusion_data_costs(mask, succ, to_ref, jp)

    want = _jax_per_jet(one, B)
    got = fused_data.fused_data_system(
        *_t(d["warped"], d["mask"]), None, None, torch.tensor(d["cw"]),
        from_jax_params(jp), mode="occ")
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-5


def test_fused_data_ref_occ_assembly(window):
    """`occ_assembly`: e0 / e1 are the occlusion costs, and the past and
    future systems are add_data_terms over the past and future offsets of
    the raw mask at du = dv = 0."""
    jp = _params()
    d = window
    z = np.zeros((H, W), np.float32)
    past = (np.arange(2 * REF) < REF)[:, None, None]

    def one(i):
        succ, to_ref, mask = d["stacks"][i]
        cw = jnp.asarray(d["cw"][i])
        return (*jmf.occlusion_data_costs(mask, succ, to_ref, jp),
                *jmf.add_data_terms(z, z, mask * past, succ, to_ref, cw, jp),
                *jmf.add_data_terms(z, z, mask * ~past, succ, to_ref, cw, jp))

    want = _jax_per_jet(one, B)
    got = fused_data.fused_data_system(
        *_t(d["warped"], d["mask"]), None, None, torch.tensor(d["cw"]),
        from_jax_params(jp), mode="occ_assembly", zero_duv=True)
    assert len(got) == 12
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-5


def test_fused_data_rejects_bad_modes(window):
    p = from_jax_params(_params())
    args = _t(window["warped"], window["mask"])
    with pytest.raises(ValueError, match="unknown mode"):
        fused_data.fused_data_system(*args, None, None, None, p, mode="x")
    with pytest.raises(ValueError, match="zero_duv"):
        fused_data.fused_data_system(*args, None, None, None, p,
                                     mode="occ_assembly")


# ------------------------------------------------------------------- K4
@pytest.mark.parametrize("motion", ["bench", "20px"])
def test_warp_stack_ref(motion):
    """K4's twin against the JAX package's non-banded warp per frame, masks
    identical. The 20 px flow is beyond the JAX shift ladder's K = 12,
    where the TPU route falls back to the banded warp; the port's gather
    needs no fallback."""
    rng = np.random.default_rng(1)
    seq = (rng.random((B, F, 3, H, W)) * 255).astype(np.float32)
    mean = (0.7, -0.4) if motion == "bench" else (20.0, -9.0)
    wx, wy = _flow(rng, B, H, W, mean=mean)
    warped, masks = warp_shift.warp_stack(*_t(seq, wx, wy), REF)
    assert warped.shape == (B, F, 3, H, W) and masks.shape == (B, F, H, W)
    for i in range(B):
        jw, jm = _jax_warp(seq[i], wx[i], wy[i], REF)
        assert _rel(warped[i], jw) <= 1e-5
        np.testing.assert_array_equal(masks[i].numpy(), jm)
    if motion == "20px":
        assert 0 < float(masks.mean()) < 0.9


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("iterations", [1, 7])
def test_sor_pallas_ref(iterations):
    """sor_coupled_rb_pallas (its twin on the CPU) against the JAX
    sor_coupled_rb from a nonzero du / dv, with nonzero boundary weights
    (which both must ignore); the inputs stay as they were."""
    rng = np.random.default_rng(2)
    shape = (B, 12, 16)
    args = [np.asarray(a, np.float32) for a in (
        rng.normal(0, 0.1, shape), rng.normal(0, 0.1, shape),
        rng.random(shape) + 1, (rng.random(shape) - 0.5) * 0.3,
        rng.random(shape) + 1, rng.normal(size=shape),
        rng.normal(size=shape), rng.random(shape) * 0.5 + 0.1,
        rng.random(shape) * 0.5 + 0.1)]
    t = _t(*args)
    before = [a.clone() for a in t]
    got = solver_pallas.sor_coupled_rb_pallas(*t, iterations=iterations,
                                              omega=1.9)
    for a, b in zip(t, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for i in range(B):
        want = jsolver.sor_coupled_rb(*(jnp.asarray(a[i]) for a in args),
                                      iterations=iterations, omega=1.9)
        for g, w_ in zip(got, want):
            assert _rel(g[i], w_) <= 1e-5


# ------------------------------------------------------------------- K6
def test_warp_stack_pallas_entry():
    """K6's entry warps every frame, factor 0 included, for factors
    -2..2; against the JAX non-banded warp, masks identical."""
    rng = np.random.default_rng(3)
    seq = (rng.random((B, 5, 3, H, W)) * 255).astype(np.float32)
    wx, wy = _flow(rng, B, H, W, scale=3.0)
    factors = (-2.0, -1.0, 0.0, 1.0, 2.0)
    out, masks = warp_pallas.warp_stack_pallas(*_t(seq, wx, wy), factors)
    for i in range(B):
        for k, f in enumerate(factors):
            jo, jm = jwarp.warp_bilinear(jnp.asarray(seq[i, k]),
                                         jnp.asarray(wx[i]),
                                         jnp.asarray(wy[i]), factor=f,
                                         banded=False)
            assert _rel(out[i, k], jo) <= 1e-5
            np.testing.assert_array_equal(masks[i, k].numpy(), np.asarray(jm))


@pytest.mark.parametrize("with_mask", [True, False])
def test_warp_bilinear_pallas_entry(with_mask):
    rng = np.random.default_rng(4)
    src = (rng.random((3, H, W)) * 255).astype(np.float32)
    wx, wy = (a[0] for a in _flow(rng, 1, H, W, scale=3.0))
    out, mask = warp_pallas.warp_bilinear_pallas(*_t(src, wx, wy), -1.5,
                                                 with_mask=with_mask)
    jo, jm = jwarp.warp_bilinear(jnp.asarray(src), jnp.asarray(wx),
                                 jnp.asarray(wy), factor=-1.5, banded=False)
    assert _rel(out, jo) <= 1e-5
    if with_mask:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    else:
        assert mask is None


# ---------------------------------------------------------- route choice
def _jax_route(jp):
    """The JAX package's branch conditions of compute_one_level
    (multiframe.py, the merged / stack / unfused choice, the fuse_occ route
    and the solve), read from its own resolvers."""
    kernel_warp = not jp.pallas_warp and jp.warp_mode == "shift"
    if jp.fused_data and jp.merge_warp_on() and kernel_warp:
        assembly = "merged"
    elif jp.fused_data and not jp.pallas_warp:
        assembly = "stack"
    else:
        assembly = "unfused"
    fuse = (assembly == "merged" and jp.self_mask_on() and jp.fuse_occ_on()
            and jp.occlusion_reasoning and not jp.one_direction
            and jp.niter_inner == 1)
    return Route(assembly, bool(fuse),
                 "fused" if jp.fused_solve_on(H, W) else "composed")


@pytest.mark.parametrize("fused_data,pallas_warp,warp_mode",
                         list(itertools.product([True, False], [False, True],
                                                ["shift", "banded"])))
def test_route_matches_jax_conditions(fused_data, pallas_warp, warp_mode):
    """Every combination of the tri-state keys, occlusion reasoning, window
    direction and niter_inner. An unset key resolves to on in the port on
    every device; the JAX package resolves it by backend, so its side gets
    the explicit True."""
    tri = (None, True, False)
    for (merge, self_mask, fuse_occ, fused_solve, occl, one_dir,
         inner) in itertools.product(tri, tri, tri, tri, (True, False),
                                     (False, True), (1, 2)):
        keys = dict(fused_data=fused_data, pallas_warp=pallas_warp,
                    warp_mode=warp_mode, merge_warp=merge,
                    self_mask=self_mask, fuse_occ=fuse_occ,
                    fused_solve=fused_solve, occlusion_reasoning=occl,
                    one_direction=one_dir, niter_inner=inner)
        port = from_jax_params(jmf.MultiFrameParams(**keys))
        jax_keys = {k: (True if v is None else v) for k, v in keys.items()}
        assert port.route() == _jax_route(jmf.MultiFrameParams(**jax_keys)), \
            keys


@pytest.mark.parametrize("cfg,route", [
    ("", Route("merged", True, "fused")),
    ("slow_flow_merge_warp\t0\n", Route("stack", False, "fused")),
    ("slow_flow_merge_warp\t0\nslow_flow_fused_solve\t0\n"
     "slow_flow_pallas_sor\t1\n", Route("stack", False, "composed")),
    ("slow_flow_warp_mode\tbanded\n", Route("stack", False, "fused")),
    ("slow_flow_fused_data\t0\nslow_flow_fused_solve\t0\n",
     Route("unfused", False, "composed")),
    ("slow_flow_fuse_occ\t0\n", Route("merged", False, "fused")),
])
def test_cfg_route_keys_reach_params(tmp_path, cfg, route):
    from slowflow_tpu.config import ParameterList

    path = tmp_path / "p.cfg"
    path.write_text(
        "slow_flow_S\t3\nslow_flow_alpha\t4\nslow_flow_gamma\t6\n"
        "slow_flow_delta\t1\nslow_flow_layers\t2\nslow_flow_p_scale\t0.9\n"
        "slow_flow_niter_outer\t3\nslow_flow_thres_outer\t1e-5\n"
        "slow_flow_niter_inner\t1\nslow_flow_thres_inner\t1e-5\n"
        "slow_flow_niter_solver\t10\nslow_flow_sor_omega\t1.9\n"
        "slow_flow_robust_color\t1\nslow_flow_robust_color_eps\t0.001\n"
        "slow_flow_robust_reg\t1\nslow_flow_robust_reg_eps\t0.001\n"
        "slow_flow_occlusion_reasoning\t1\n" + cfg)
    params = ParameterList()
    params.read(str(path))
    assert MultiFrameParams.from_parameter_list(params).route() == route


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_problem(device, seed, h=45, w=70, motion=(1.0, -0.5)):
    rng = np.random.default_rng(seed)
    seq = (rng.random((B, F, 3, h, w)) * 255).astype(np.float32)
    wx, wy = _flow(rng, B, h, w, mean=motion)
    occ = rng.integers(-1, 2, (B, h, w)).astype(np.float32)
    du = rng.normal(0, 0.2, (B, h, w)).astype(np.float32)
    dv = rng.normal(0, 0.2, (B, h, w)).astype(np.float32)
    cw = (0.5 + rng.random((B, 3, h, w))).astype(np.float32)
    return [t.to(device) for t in _t(seq, wx, wy, occ, du, dv, cw)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,zero_duv", [("assembly", False),
                                           ("assembly", True),
                                           ("occ", False),
                                           ("occ_assembly", True)])
def test_fused_data_kernel_matches_twin(cuda_device, mode, zero_duv):
    seq, wx, wy, occ, du, dv, cw = _card_problem(cuda_device, 5)
    p = from_jax_params(_params())
    warped, masks = warp_shift.warp_stack_ref(seq, wx, wy, REF)
    mask = terms.succ_mask(masks, REF)
    if mode == "assembly":
        mask = terms.gate_masks(mask, occ, p)
    got = fused_data.fused_data_system(warped, mask, du, dv, cw, p,
                                       mode=mode, zero_duv=zero_duv)
    want = fused_data.fused_data_system_ref(warped, mask, du, dv, cw, p,
                                            mode=mode, zero_duv=zero_duv)
    for g, w_ in zip(got, want):
        assert _rel(g.cpu(), w_.cpu()) <= 1e-4   # FMA contraction in nvcc


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["assembly", "occ"])
def test_stack_kernels_match_merged_kernel(cuda_device, mode):
    """K3 on K4's stack with succ_mask (gated in assembly mode) equals K2."""
    seq, wx, wy, occ, du, dv, cw = _card_problem(cuda_device, 6)
    p = from_jax_params(_params())
    warped, masks = warp_shift.warp_stack(seq, wx, wy, REF)
    mask = terms.succ_mask(masks, REF)
    if mode == "assembly":
        mask = terms.gate_masks(mask, occ, p)
    got = fused_data.fused_data_system(warped, mask, du, dv, cw, p,
                                       mode=mode)
    want = fused_warp.warp_assemble(seq, wx, wy, occ, du, dv, cw, p,
                                    mode=mode)
    for g, w_ in zip(got, want):
        assert _rel(g.cpu(), w_.cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("motion", [(1.0, -0.5), (20.0, -9.0)])
def test_warp_stack_kernel_matches_twin(cuda_device, motion):
    """Same rounding as the twin (no FMA contraction): bit for bit."""
    seq, wx, wy, *_ = _card_problem(cuda_device, 7, motion=motion)
    got = warp_shift.warp_stack(seq, wx, wy, REF)
    want = warp_shift.warp_stack_ref(seq, wx, wy, REF)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.cuda
def test_warp_pallas_entries_match_twins(cuda_device):
    seq, wx, wy, *_ = _card_problem(cuda_device, 8)
    factors = (-2.0, -1.0, 0.0, 1.0, 2.0)
    got = warp_pallas.warp_stack_pallas(seq, wx, wy, factors)
    want = warp_pallas.warp_stack_pallas_ref(seq, wx, wy, factors)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    got = warp_pallas.warp_bilinear_pallas(seq[:, 1], wx, wy, 1.5)
    want = warp_pallas.warp_bilinear(seq[:, 1], wx, wy, 1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [1, 30])
def test_sor_kernel_matches_twin(cuda_device, iterations):
    rng = np.random.default_rng(9)
    shape = (B, 45, 70)
    args = [torch.tensor(np.asarray(a, np.float32), device=cuda_device)
            for a in (rng.normal(0, 0.1, shape), rng.normal(0, 0.1, shape),
                      rng.random(shape) + 1,
                      (rng.random(shape) - 0.5) * 0.3, rng.random(shape) + 1,
                      rng.normal(size=shape), rng.normal(size=shape),
                      rng.random(shape) * 0.5 + 0.1,
                      rng.random(shape) * 0.5 + 0.1)]
    before = [a.clone() for a in args]
    kernels.reset_launch_counts()
    got = solver_pallas.sor_coupled_rb_pallas(*args, iterations=iterations)
    assert kernels.LAUNCHES["sor"] == 1
    want = solver_pallas.sor_coupled_rb(*args, iterations=iterations)
    for a, b in zip(args, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for g, w_ in zip(got, want):
        assert _rel(g.cpu(), w_.cpu()) <= 1e-4   # FMA contraction in nvcc


@pytest.mark.cuda
@pytest.mark.parametrize("route", [
    dict(),
    dict(merge_warp=False, fused_solve=False),
    dict(pallas_warp=True, fused_solve=False),
])
def test_routes_on_the_card_with_two_inner_iterations(cuda_device, route):
    """niter_inner = 2 hands the data-term kernels a zero increment on the
    first inner iteration; every route runs it on the card and lands near
    its CPU run (a few FMA bits through 2 IRLS steps)."""
    from slowflow_tpu_torch.variational import multiframe as tmf

    p = dataclasses.replace(
        MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=1,
                         niter_alter=2, niter_outer=2, niter_inner=2,
                         niter_solver=10, smoothing=1), **route)
    rng = np.random.default_rng(10)
    seq = rng.random((B, F, 3, 32, 48)).astype(np.float32) * 255
    z = np.zeros((B, 32, 48), np.float32)
    card = tmf.variational_mt_batched(z, z, seq, p, device=cuda_device)
    cpu = tmf.variational_mt_batched(z, z, seq, p, device="cpu")
    for a, b in zip(card[:2], cpu[:2]):
        assert torch.isfinite(a).all()
        assert float((a.cpu() - b).abs().median()) <= 1e-3
