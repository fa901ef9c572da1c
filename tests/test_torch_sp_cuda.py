"""The kernels' strip arguments on the card (core/rows.py `StripRows`:
each window's first image row, its own rows, the image's height) against
their plain twins, the sp row split of one level on two strips of one
card against the unsharded level, and that split through its CUDA graphs
against its eager form.

K1 / K5: windows starting on odd and even image rows (the colours follow the
image), own-row ranges at both image edges and inside (K1's change sums);
K2 in every mode and K4 / K6's entry: row0 != 0 and img_h above the window,
flows that leave the window and the image. Bounds as in
tests/test_torch_kernels_cuda.py: 1e-4 of each plane's max for K1 / K2 / K5
(nvcc's FMA contraction), K4 / K6 bit-equal. The level on
["cuda:0", "cuda:0"] is bitwise the unsharded call or within chip_smoke's
slice tolerances (K1's band plan and its sums' order follow the batch of
windows, which can move an exit). Through the CUDA graphs the split is
bitwise its eager form on 1x2 and 2x2 meshes of one card (and on two
cards where there are two), merged and pinned, with a widening; the second
call captures nothing; the launch, exchange and widening counts are the
eager ones; a segment that cannot be captured raises and nothing falls
back to the eager level. Two ranks on one card (one host thread a strip,
where StripPlan would fold them into one rank) capture their graphs cut at
the collectives and replay them, bitwise the eager two-rank split. Every test needs a CUDA GPU and skips without
one.

    python -m pytest tests/test_torch_sp_cuda.py -m cuda
"""
from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.core import solver, solver_pallas, warp_pallas, \
    warp_shift
from slowflow_tpu_torch.core.rows import StripRows
from slowflow_tpu_torch.parallel import mesh as pmesh
from slowflow_tpu_torch.parallel import strips as pstrips
from slowflow_tpu_torch.parallel.strips import run_strips
from slowflow_tpu_torch.variational import (fused_solve, fused_warp, graphs,
                                            multiframe)
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


def _sp_inputs(device, route):
    """A level at 4 x 120 x 160 on the bench scene moving (1.5, -0.8) px a
    frame from zero flow (the windows widen as the flow grows): the merged
    route (K2 + K1) or the JAX sp path's pinned route (unfused, K4 + K5)."""
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
    seq = torch.tensor((seq - seq.mean()) / seq.std(), device=device)
    zero = torch.zeros((b, h, w), device=device)
    cw = torch.ones((b, 3, h, w), device=device)
    na = torch.zeros((b, 3), device=device)
    ns = torch.ones((b, 3), device=device)
    return p, (zero, zero, seq, cw, na, ns)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["merged", "pinned"])
def test_sp_level_on_two_strips_of_one_card(cuda_device, route):
    """One level at 4 x 120 x 160 through the kernels, rows split in two
    on ["cuda:0", "cuda:0"] (one batch of 8 windows), against the unsharded
    call: the merged route (K2 + K1) and the JAX sp path's pinned route
    (unfused, K4 + K5)."""
    p, args = _sp_inputs(cuda_device, route)
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


def _eager_sp(mesh, p, args):
    """run_strips over the eager level (the private `_eager`): (outputs,
    plan, launch counts)."""
    eager = functools.partial(multiframe.compute_one_level, _eager=True)
    with mock.patch.object(multiframe, "compute_one_level", eager):
        kernels.reset_launch_counts()
        out, plan = run_strips(mesh, p, *args)
        torch.cuda.synchronize()
    return out, plan, dict(kernels.LAUNCHES)


def _graphed_sp_twice(mesh, p, args, cuts=None):
    """Two run_strips calls through the CUDA graphs, each held bitwise to
    the eager strip level with its launches, exchanges and widenings; the
    first captures, the second only replays (and, given the list `cuts`
    that capture cuts are appended to, cuts nothing)."""
    want, eplan, counts = _eager_sp(mesh, p, args)
    assert eplan.widenings > 0 and eplan.exchanges > 0
    graphs.reset_stats()
    for call in range(2):
        captures = graphs.STATS["captures"]
        cut = len(cuts or ())
        kernels.reset_launch_counts()
        got, plan = run_strips(mesh, p, *args)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x), (call, (g - x).abs().max().item())
        assert dict(kernels.LAUNCHES) == counts, call
        assert (plan.exchanges, plan.widenings) == (eplan.exchanges,
                                                    eplan.widenings)
        new = graphs.STATS["captures"] - captures
        assert new > 0 if call == 0 else new == 0, (call, new)
        if cuts is not None:
            new = len(cuts) - cut
            assert new > 0 if call == 0 else new == 0, (call, new)
    return eplan


@pytest.mark.cuda
@pytest.mark.parametrize("n_jet", [1, 2])
@pytest.mark.parametrize("route", ["merged", "pinned"])
def test_graphed_sp_level_equals_eager(cuda_device, route, n_jet):
    """The strip level through its CUDA graphs (one Program per window
    geometry) on 1x2 and 2x2 meshes of one card, bitwise the eager strip
    level on the capturing and the replaying call, with a widening."""
    p, args = _sp_inputs(cuda_device, route)
    graphs.clear()
    try:
        plan = _graphed_sp_twice(
            pmesh.make_mesh(n_jet, 2, ["cuda:0"] * (2 * n_jet)), p, args)
        assert len(graphs.cached_keys()) == plan.widenings + 1
    finally:
        graphs.clear()


@pytest.mark.cuda
def test_graphed_sp_level_on_two_cards(cuda_device):
    """Two ranks, one a card, each capturing its graphs cut at the
    collectives: bitwise the eager split, the second call replays."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    p, args = _sp_inputs(cuda_device, "merged")
    _graphed_sp_twice(pmesh.make_mesh(1, 2, ["cuda:0", "cuda:1"]), p, args)


class _RankPerStrip(pstrips.StripPlan):
    """A plan whose entries share one card, split into one rank a strip
    (StripPlan folds the entries of one device into one rank): each rank
    runs on a host thread and a stream of its own, and its collectives are
    host steps between the rank's captured parts."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        dev, = self.devices
        self.devices = [dev] * self.n_sp
        self.local = [[g for g in range(self.b * self.n_sp)
                       if g % self.n_sp == s] for s in range(self.n_sp)]
        self.group = pstrips._Group(self.n_sp)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["merged", "pinned"])
def test_graphed_two_ranks_on_one_card(cuda_device, route):
    """Two ranks on cuda:0 through their CUDA graphs: each capture is cut
    at the collectives (the lock handed between the ranks' captures, every
    collective run once in the eager pass and once in the capture pass),
    the replays run the host steps between the parts and copy their
    results into the captured tensors; bitwise the eager two-rank split,
    with a widening, equal counts, and the second call cuts nothing."""
    p, args = _sp_inputs(cuda_device, route)
    mesh = pmesh.make_mesh(1, 2, ["cuda:0"] * 2)
    cuts = []
    cut = graphs._Capture.cut

    def counted(self, step):
        cuts.append(step.__code__.co_names[-1])
        return cut(self, step)

    def clear_ranks():
        for r in range(2):
            pmesh._worker(r, "strip-rank").submit(graphs.clear).result()

    clear_ranks()
    try:
        with mock.patch.object(pstrips, "StripPlan", _RankPerStrip), \
                mock.patch.object(graphs._Capture, "cut", counted):
            plan = _graphed_sp_twice(mesh, p, args, cuts)
        assert plan.group.n == 2
        assert {"_swap", "_gathered_total"} <= set(cuts)
    finally:
        clear_ranks()


@pytest.mark.cuda
def test_a_capture_error_raises_and_nothing_falls_back(cuda_device):
    """A segment that reads the device on the host runs in its eager first
    run but cannot be captured: the call raises, no eager level runs after
    it, the failed Programs are dropped, and the next call runs bitwise."""
    p, args = _sp_inputs(cuda_device, "merged")
    mesh = pmesh.make_mesh(1, 2, ["cuda:0"] * 2)
    rate, drive = multiframe._Level.rate, multiframe._Level.drive
    levels = []

    def host_read(self, sums):
        out = rate(self, sums)
        float(out.sum())
        return out

    def logged(self, run):
        levels.append(self.graphed)
        return drive(self, run)

    graphs.clear()
    with mock.patch.object(multiframe._Level, "rate", host_read), \
            mock.patch.object(multiframe._Level, "drive", logged), \
            pytest.raises(RuntimeError):
        run_strips(mesh, p, *args)
    assert levels == [True]
    assert graphs.cached_keys() == []
    try:
        _graphed_sp_twice(mesh, p, args)
    finally:
        graphs.clear()
