"""The plain twins of the port's two CUDA kernels against the JAX package.

K2 twin `warp_assemble_ref` is held to get_derivatives_mt + add_data_terms /
occlusion_data_costs, K1 twin `solve_step_ref` to compute_smoothness_mt +
sub_laplacian + sor_coupled_rb, both on the JAX package's XLA route (the
non-banded warp at these sizes). Inputs come from a numpy seed; tolerances
are relative to the largest |value| of the JAX plane (float32 sums taken in
another order). Tests marked `cuda` hold the kernels to the twins and need a
GPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slowflow_tpu.variational import multiframe as jmf
from slowflow_tpu_torch.variational import fused_solve, fused_warp, terms
from slowflow_tpu_torch.variational.params import (MultiFrameParams,
                                                   from_jax_params)

JP = jmf.MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0,
                          rho=(1.0, 1.0), omega=(0.0, 2.0),
                          occlusion_reasoning=True, smoothing=1,
                          warp_mode="banded", fused_data=False)
P = from_jax_params(JP)
B, H, W = 2, 40, 56


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the twins, so that no reduction of theirs
    can split by the worker's thread count (the xdist workers share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _problem(seed=0, b=B, h=H, w=W, s=3):
    rng = np.random.default_rng(seed)
    f = 2 * (s - 1) + 1
    seq = (rng.random((b, f, 3, h, w)) * 255).astype(np.float32)
    coarse = rng.normal(0, 1, (b, 2, h // 8 + 2, w // 8 + 2))
    flow = np.kron(coarse, np.ones((8, 8)))[..., :h, :w] * 1.5
    wx = (flow[:, 0] + 0.7).astype(np.float32)
    wy = (flow[:, 1] - 0.4).astype(np.float32)
    occ = rng.integers(-1, 2, (b, h, w)).astype(np.float32)
    du = rng.normal(0, 0.2, (b, h, w)).astype(np.float32)
    dv = rng.normal(0, 0.2, (b, h, w)).astype(np.float32)
    cw = (0.5 + rng.random((b, 3, h, w))).astype(np.float32)
    return seq, wx, wy, occ, du, dv, cw


def _gate(mask, occ, p):
    """compute_one_level.gate_masks of the JAX package, in numpy."""
    dn = sum(p.rho[s] + p.omega[s] for s in range(p.ref))
    factor = (1.0 + (occ == 0)) * dn
    backward = (occ >= 0) / factor
    forward = (occ <= 0) / factor
    past = (np.arange(2 * p.ref) < p.ref)[:, None, None]
    return np.asarray(mask) * np.where(past, backward[None], forward[None])


def _jax_system(jp, seq, wx, wy, occ, du, dv, cw, mode):
    outs = []
    for i in range(seq.shape[0]):
        succ, to_ref, mask = jmf.get_derivatives_mt(
            jnp.asarray(seq[i]), jnp.asarray(wx[i]), jnp.asarray(wy[i]),
            jp.ref, warp_mode="banded")
        if mode == "occ":
            outs.append(jmf.occlusion_data_costs(mask, succ, to_ref, jp))
            continue
        gated = jnp.asarray(_gate(mask, occ[i], jp), jnp.float32)
        outs.append(jmf.add_data_terms(jnp.asarray(du[i]), jnp.asarray(dv[i]),
                                       gated, succ, to_ref,
                                       jnp.asarray(cw[i]), jp))
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("zero_duv", [False, True])
def test_warp_assemble_ref_assembly(zero_duv):
    seq, wx, wy, occ, du, dv, cw = _problem(1)
    if zero_duv:
        du = np.zeros_like(du)
        dv = np.zeros_like(dv)
    want = _jax_system(JP, seq, wx, wy, occ, du, dv, cw, "assembly")
    got = fused_warp.warp_assemble_ref(*_t(seq, wx, wy, occ, du, dv, cw), P,
                                       mode="assembly", zero_duv=zero_duv)
    assert len(got) == 5
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-5


def test_warp_assemble_ref_occ():
    seq, wx, wy, occ, du, dv, cw = _problem(2)
    want = _jax_system(JP, seq, wx, wy, occ, du, dv, cw, "occ")
    got = fused_warp.warp_assemble_ref(*_t(seq, wx, wy, occ, du, dv, cw), P,
                                       mode="occ")
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-5


def test_warp_assemble_ref_occ_assembly():
    """e0/e1 match the occlusion costs; the gated sum of the past and future
    halves matches the gated JAX assembly at du = dv = 0."""
    seq, wx, wy, occ, _, _, cw = _problem(3)
    z = np.zeros_like(wx)
    want_occ = _jax_system(JP, seq, wx, wy, occ, z, z, cw, "occ")
    want_sys = _jax_system(JP, seq, wx, wy, occ, z, z, cw, "assembly")
    outs = fused_warp.warp_assemble_ref(*_t(seq, wx, wy, occ, z, z, cw), P,
                                        mode="occ_assembly", zero_duv=True)
    assert len(outs) == 12
    for g, w_ in zip(outs[:2], want_occ):
        assert _rel(g, w_) <= 1e-5
    backward, forward = terms.direction_weights(torch.tensor(occ),
                                                terms.data_norm(P))
    for k in range(5):
        folded = backward * outs[2 + k] + forward * outs[7 + k]
        assert _rel(folded, want_sys[k]) <= 1e-5


def test_warp_assemble_one_direction_gate():
    jp = jmf.MultiFrameParams(**{**JP.__dict__, "one_direction": True})
    seq, wx, wy, occ, du, dv, cw = _problem(4)
    want = _jax_system(jp, seq, wx, wy, occ, du, dv, cw, "assembly")
    got = fused_warp.warp_assemble(*_t(seq, wx, wy, occ, du, dv, cw),
                                   from_jax_params(jp), mode="assembly")
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= 1e-5


def _solve_problem(seed):
    rng = np.random.default_rng(seed)
    uu = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    vv = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    dpsis = (0.5 * rng.random((B, H, W))).astype(np.float32)
    a11 = (1 + rng.random((B, H, W))).astype(np.float32)
    a22 = (1 + rng.random((B, H, W))).astype(np.float32)
    a12 = (0.3 * rng.normal(0, 1, (B, H, W))).astype(np.float32)
    b1 = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    b2 = rng.normal(0, 1, (B, H, W)).astype(np.float32)
    du = rng.normal(0, 0.1, (B, H, W)).astype(np.float32)
    dv = rng.normal(0, 0.1, (B, H, W)).astype(np.float32)
    return uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv


def _jax_solve(jp, args, zero_init, method):
    from slowflow_tpu.core.solver import sor_coupled_rb

    _, _, reg = jp.penalties()
    uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv = args
    outs = []
    for i in range(B):
        j = [jnp.asarray(a[i]) for a in args]
        wh, wv = jmf.compute_smoothness_mt(j[0], j[1], j[2], jp.alpha, reg,
                                           method)
        r1 = jmf.sub_laplacian(j[6], j[0], wh, wv)
        r2 = jmf.sub_laplacian(j[7], j[1], wh, wv)
        d0 = jnp.zeros_like(j[0]) if zero_init else j[8]
        e0 = jnp.zeros_like(j[0]) if zero_init else j[9]
        ndu, ndv = sor_coupled_rb(d0, e0, j[3], j[4], j[5], r1, r2, wh, wv,
                                  iterations=jp.niter_solver,
                                  omega=jp.sor_omega)
        sums = [float(jnp.abs(ndu - d0).sum()), float(jnp.abs(ndv - e0).sum())]
        outs.append((np.asarray(ndu), np.asarray(ndv), sums))
    return (np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]),
            np.asarray([o[2] for o in outs]))


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("zero_init", [True, False])
def test_solve_step_ref(method, zero_init):
    args = _solve_problem(10 + method)
    jp = jmf.MultiFrameParams(**{**JP.__dict__, "smoothing": method,
                                 "niter_solver": 12})
    want = _jax_solve(jp, args, zero_init, method)
    t = _t(*args)
    du, dv = (None, None) if zero_init else (t[8], t[9])
    _, _, reg = P.penalties()
    ndu, ndv, sums = fused_solve.solve_step(
        *t[:8], du, dv, alpha=jp.alpha, reg_pen=reg, method=method,
        iterations=jp.niter_solver, omega=jp.sor_omega, with_change=True)
    assert _rel(ndu, want[0]) <= 1e-5
    assert _rel(ndv, want[1]) <= 1e-5
    assert _rel(sums, want[2]) <= 1e-5


def test_solve_binary_potts_identical():
    rng = np.random.default_rng(20)
    e0 = (0.05 * rng.random((B, H, W))).astype(np.float32)
    e1 = (0.05 * rng.random((B, H, W)) + 0.02).astype(np.float32)
    got = terms.solve_binary_potts(torch.tensor(e0), torch.tensor(e1), 0.1, 10)
    for i in range(B):
        want = jmf.solve_binary_potts(jnp.asarray(e0[i]), jnp.asarray(e1[i]),
                                      0.1, 10)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_dpsis_and_smoothness_terms():
    rng = np.random.default_rng(21)
    im = (rng.normal(0, 1, (B, 3, H, W))).astype(np.float32)
    avg = rng.random((B, 3)).astype(np.float32) * 100
    std = (rng.random((B, 3)) + 0.5).astype(np.float32)
    got = terms.compute_dpsis_weight_mt(*_t(im, avg, std))
    for i in range(B):
        want = jmf.compute_dpsis_weight_mt(jnp.asarray(im[i]),
                                           jnp.asarray(avg[i]),
                                           jnp.asarray(std[i]))
        assert _rel(got[i], want) <= 1e-5


def test_params_carry_over_and_route_keys_ignored(tmp_path):
    """The numeric keys and the route keys parse as in the JAX package and
    carry over through from_jax_params; the route keys are honoured (they
    pick the port's route), and only the layout / batching keys of
    TPU_ROUTE_KEYS are ignored."""
    from slowflow_tpu.config import ParameterList
    from slowflow_tpu_torch.variational.params import TPU_ROUTE_KEYS, Route

    def parsed(extra):
        cfg = tmp_path / "p.cfg"
        cfg.write_text(
            "slow_flow_S\t3\nslow_flow_alpha\t4.0\nslow_flow_gamma\t6\n"
            "slow_flow_delta\t1\nslow_flow_layers\t5\n"
            "slow_flow_p_scale\t0.9\nslow_flow_niter_outer\t10\n"
            "slow_flow_thres_outer\t1e-5\nslow_flow_niter_inner\t1\n"
            "slow_flow_thres_inner\t1e-5\nslow_flow_niter_solver\t30\n"
            "slow_flow_sor_omega\t1.9\nslow_flow_robust_color\t1\n"
            "slow_flow_robust_color_eps\t0.001\nslow_flow_robust_reg\t1\n"
            "slow_flow_robust_reg_eps\t0.001\nslow_flow_omega_0\t0\n"
            "slow_flow_omega_1\t2\nslow_flow_occlusion_reasoning\t1\n"
            + extra)
        params = ParameterList()
        params.read(str(cfg))
        mine = MultiFrameParams.from_parameter_list(params)
        theirs = jmf.MultiFrameParams.from_parameter_list(params)
        assert mine == from_jax_params(theirs)
        return mine

    mine = parsed("slow_flow_merge_warp\t1\nslow_flow_fused_solve\t1\n"
                  "slow_flow_warp_mode\tshift\n")
    assert mine.omega == (0.0, 2.0) and mine.ref == 2
    assert mine.route() == Route("merged", True, "fused")
    assert parsed("").route() == Route("merged", True, "fused")
    assert parsed("slow_flow_merge_warp\t0\nslow_flow_fused_solve\t0\n"
                  ).route() == Route("stack", False, "composed")
    assert parsed("slow_flow_fused_data\t0\n").route() == \
        Route("unfused", False, "fused")
    assert parsed("slow_flow_warp_mode\tbanded\n").route().assembly == \
        "stack"
    assert parsed("slow_flow_fuse_occ\t0\n").route() == \
        Route("merged", False, "fused")
    assert parsed("slow_flow_self_mask\t0\n").route() == \
        Route("merged", False, "fused")
    ignored = parsed("".join(f"{k}\t1\n" for k in TPU_ROUTE_KEYS))
    assert ignored == parsed("")


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,zero_duv", [("assembly", False),
                                           ("assembly", True),
                                           ("occ", False),
                                           ("occ_assembly", True)])
def test_warp_assemble_kernel_matches_twin(cuda_device, mode, zero_duv):
    args = [t.to(cuda_device) for t in _t(*_problem(5, h=45, w=70))]
    got = fused_warp.warp_assemble(*args, P, mode=mode, zero_duv=zero_duv)
    want = fused_warp.warp_assemble_ref(*args, P, mode=mode,
                                        zero_duv=zero_duv)
    for g, w_ in zip(got, want):
        assert _rel(g.cpu(), w_.cpu()) <= 1e-4   # FMA contraction in nvcc


@pytest.mark.cuda
@pytest.mark.parametrize("s,change", [
    (2, {"S": 2, "rho": (1.0,), "omega": (1.0,)}),
    (3, {"one_direction": True, "dataterm_norm": False}),
    (4, {"S": 4, "rho": (1.0, 0.5, 0.25), "omega": (0.0, 2.0, 1.0),
         "robust_color": (2, 0.01, 0.5), "robust_grad": (4, 0.001, 0.5)}),
])
def test_warp_assemble_kernel_other_windows(cuda_device, s, change):
    p = from_jax_params(jmf.MultiFrameParams(**{**JP.__dict__, **change}))
    args = [t.to(cuda_device) for t in _t(*_problem(6, h=33, w=50, s=s))]
    for mode in ("assembly", "occ"):
        got = fused_warp.warp_assemble(*args, p, mode=mode)
        want = fused_warp.warp_assemble_ref(*args, p, mode=mode)
        for g, w_ in zip(got, want):
            assert _rel(g.cpu(), w_.cpu()) <= 1e-4   # FMA contraction


@pytest.mark.cuda
@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("zero_init", [True, False])
def test_solve_step_kernel_matches_twin(cuda_device, method, zero_init):
    t = [a.to(cuda_device) for a in _t(*_solve_problem(30))]
    du, dv = (None, None) if zero_init else (t[8], t[9])
    _, _, reg = P.penalties()
    kw = dict(alpha=4.0, reg_pen=reg, method=method, iterations=30,
              omega=1.9, with_change=True)
    got = fused_solve.solve_step(*t[:8], du, dv, **kw)
    want = fused_solve.solve_step_ref(*t[:8], du, dv, **kw)
    for g, w_ in zip(got, want):
        assert _rel(g.cpu(), w_.cpu()) <= 1e-4   # FMA contraction in nvcc
