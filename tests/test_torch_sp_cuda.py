"""The kernels' strip arguments on the card (core/rows.py `StripRows`:
each window's first image row, its own rows, the image's height) against
their plain twins, and the sp row split of one level on two strips of one
card against the unsharded level.

K1 / K5: windows starting on odd and even image rows (the colours follow the
image), own-row ranges at both image edges and inside (K1's change sums);
K2 in every mode and K4 / K6's entry: row0 != 0 and img_h above the window,
flows that leave the window and the image. Bounds as in
tests/test_torch_kernels_cuda.py: 1e-4 of each plane's max for K1 / K2 / K5
(nvcc's FMA contraction), K4 / K6 bit-equal. The level on
["cuda:0", "cuda:0"] is bitwise the unsharded call or within chip_smoke's
slice tolerances (K1's band plan and its sums' order follow the batch of
windows, which can move an exit). Every test needs a CUDA GPU and skips
without one.

    python -m pytest tests/test_torch_sp_cuda.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.core import solver, solver_pallas, warp_pallas, \
    warp_shift
from slowflow_tpu_torch.core.rows import StripRows
from slowflow_tpu_torch.parallel import mesh as pmesh
from slowflow_tpu_torch.parallel.strips import run_strips
from slowflow_tpu_torch.variational import fused_solve, fused_warp
from slowflow_tpu_torch.variational.multiframe import compute_one_level
from slowflow_tpu_torch.variational.params import MultiFrameParams

P = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0, rho=(1.0, 1.0),
                     omega=(0.0, 2.0), niter_solver=30, smoothing=1)
TOL = 1e-4
IMG_H = 301
# (first image row, own rows [lo, hi)) of windows of 77 rows: the top and
# bottom edges, odd and even starts
WIN_H = 77
WINDOWS = [(0, (0, 40)), (37, (20, 57)), (100, (13, 64)), (IMG_H - WIN_H,
                                                          (30, WIN_H))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _rows(device):
    return StripRows(torch.tensor([(s, lo, hi) for s, (lo, hi) in WINDOWS],
                                  dtype=torch.int32, device=device), IMG_H)


def _planes(n, b, h, w, seed, device, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(0, scale, (b, h, w)) + shift,
                         dtype=torch.float32, device=device)
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [64, 33])
def test_solve_step_rows_against_twin(cuda_device, w):
    b = len(WINDOWS)
    uu, vv, b1, b2 = _planes(4, b, WIN_H, w, 1, cuda_device)
    dpsis, a11, a22 = (p.abs() * 0.5 + 0.5 for p in
                       _planes(3, b, WIN_H, w, 2, cuda_device))
    a12, du, dv = _planes(3, b, WIN_H, w, 3, cuda_device, 0.1)
    _, _, reg = P.penalties()
    rows = _rows(cuda_device)
    for method in (0, 1, 2):
        for start in ((None, None), (du, dv)):
            kw = dict(alpha=P.alpha, reg_pen=reg, method=method,
                      iterations=30, omega=1.9, with_change=True, rows=rows)
            args = (uu, vv, dpsis, a11, a12, a22, b1, b2, *start)
            got = fused_solve.solve_step(*args, **kw)
            want = fused_solve.solve_step_ref(*args, **kw)
            for g, wnt in zip(got, want):
                assert _rel(g.cpu(), wnt.cpu()) <= TOL, method
            # no rows: the colours of row 0 differ for the odd windows
            plain = fused_solve.solve_step(*args, **{**kw, "rows": None})
            assert not torch.equal(plain[0][1], got[0][1])


@pytest.mark.cuda
def test_sor_rows_against_twin(cuda_device):
    b = len(WINDOWS)
    du, dv, b1, b2, a12 = _planes(5, b, WIN_H, 45, 4, cuda_device, 0.3)
    a11, a22, wh, wv = (p.abs() + 0.2 for p in
                        _planes(4, b, WIN_H, 45, 5, cuda_device))
    rows = _rows(cuda_device)
    args = (du, dv, a11, a12, a22, b1, b2, wh, wv)
    got = solver_pallas.sor_coupled_rb_pallas(*args, iterations=30,
                                              omega=1.9, rows=rows)
    want = solver.sor_coupled_rb(*args, iterations=30, omega=1.9, rows=rows)
    for g, wnt in zip(got, want):
        assert _rel(g.cpu(), wnt.cpu()) <= TOL


def _window_inputs(device, w=53, seed=6):
    b = len(WINDOWS)
    rng = np.random.default_rng(seed)
    seq = torch.tensor(rng.random((b, 5, 3, WIN_H, w)) * 255,
                       dtype=torch.float32, device=device)
    wx = torch.tensor(rng.normal(0.5, 2, (b, WIN_H, w)), dtype=torch.float32,
                      device=device)
    # reaches beyond the window and, on the edge windows, the image
    wy = torch.tensor(rng.normal(0, 8, (b, WIN_H, w)), dtype=torch.float32,
                      device=device)
    return seq, wx, wy


@pytest.mark.cuda
def test_warp_assemble_rows_against_twin(cuda_device):
    seq, wx, wy = _window_inputs(cuda_device)
    b, _, _, h, w = seq.shape
    occ, du, dv = _planes(3, b, h, w, 7, cuda_device)
    occ = occ.sign()
    du, dv = 0.1 * du, 0.1 * dv
    cw = torch.ones((b, 3, h, w), device=cuda_device)
    rows = _rows(cuda_device)
    for mode, zero in (("assembly", False), ("assembly", True),
                       ("occ", True), ("occ_assembly", True)):
        args = (seq, wx, wy, occ, du, dv, cw, P)
        got = fused_warp.warp_assemble(*args, mode=mode, zero_duv=zero,
                                       rows=rows)
        want = fused_warp.warp_assemble_ref(*args, mode=mode, zero_duv=zero,
                                            rows=rows)
        for g, wnt in zip(got, want):
            assert _rel(g.cpu(), wnt.cpu()) <= TOL, mode


@pytest.mark.cuda
def test_warp_stack_rows_bit_equal(cuda_device):
    seq, wx, wy = _window_inputs(cuda_device, w=37)
    rows = _rows(cuda_device)
    got = warp_shift.warp_stack(seq, wx, wy, 2, rows)
    want = warp_shift.warp_stack_ref(seq, wx, wy, 2, rows)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    factors = [-2.0, -1.0, 0.0, 1.0, 2.0]
    got = warp_pallas.warp_stack_pallas(seq, wx, wy, factors, rows)
    want = warp_pallas.warp_stack_pallas_ref(seq, wx, wy, factors, rows)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["merged", "pinned"])
def test_sp_level_on_two_strips_of_one_card(cuda_device, route):
    """One level at 4 x 120 x 160 through the kernels, rows split in two
    on ["cuda:0", "cuda:0"] (one batch of 8 windows), against the unsharded
    call: the merged route (K2 + K1) and the JAX sp path's pinned route
    (unfused, K4 + K5)."""
    from slowflow_tpu_torch.bench_scene import moving_sequence

    kw = {} if route == "merged" else dict(fused_data=False,
                                           warp_mode="banded",
                                           fused_solve=False)
    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0),
                         niter_alter=3, niter_outer=3, niter_solver=10,
                         occlusion_reasoning=True, smoothing=1, **kw)
    b, h, w = 4, 120, 160
    seq = np.stack([moving_sequence(5, h, w, 1.5, -0.8, seed=j)
                    for j in range(b)]).astype(np.float32)
    seq = torch.tensor((seq - seq.mean()) / seq.std(), device=cuda_device)
    zero = torch.zeros((b, h, w), device=cuda_device)
    cw = torch.ones((b, 3, h, w), device=cuda_device)
    na = torch.zeros((b, 3), device=cuda_device)
    ns = torch.ones((b, 3), device=cuda_device)
    args = (zero, zero, seq, cw, na, ns)
    want = compute_one_level(*args, p=p)
    kernels.reset_launch_counts()
    got, plan = run_strips(pmesh.make_mesh(1, 2, ["cuda:0"] * 2), p, *args)
    counts = dict(kernels.LAUNCHES)
    names = {"merged": ("warp_assemble", "solve_step"),
             "pinned": ("warp_stack", "sor")}[route]
    assert all(counts[n] > 0 for n in names), counts
    assert sum(counts.values()) == sum(counts[n] for n in names), counts
    assert plan.exchanges > 0
    if not all(torch.equal(g, x) for g, x in zip(got, want)):
        d = torch.hypot(got[0] - want[0], got[1] - want[1])
        assert d.median().item() <= 1e-3 and d.mean().item() <= 1e-2
        assert (got[2] != want[2]).float().mean().item() <= 0.01
