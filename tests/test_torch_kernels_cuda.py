"""The one-launch K1 / K5 (csrc/solve_step.cu), the K2 / K3 assembly
kernels and the K4 / K6 warp kernel against their plain twins on the card,
at the shapes that reach their edge cases: odd H and W, widths under one
warp, a single jet, B = 16 (K1 / K5's grouped path), 0 / 1 / 30 sweeps,
with and without du / dv and the change sums; K1 / K5's plan against
`fused_solve.plan_model`, and their grouped (even and uneven groups, odd H
and W) and row-streamed paths bitwise equal to the jets solved one at a
time, with strip tables of odd first rows and inside a CUDA graph; K2 and
K3 in every mode at
odd shapes and window sizes S = 2 and 4 (S = 1 has no offsets and no data
term), K3's tiles at every image edge and on K4's stack against K2; K4 and
K6's entry at W < 4 and W not a multiple of 4, B = 1, F = 16, the identity
frame copied or warped, flows of 0.3 px, 20 px and far outside the image.
Bound: 1e-4 of each plane's max, for nvcc's FMA contraction; the warp is
bit-equal. Every test needs a CUDA GPU and skips without one.

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.core import (solver, solver_pallas, warp_pallas,
                                     warp_shift)
from slowflow_tpu_torch.core.rows import StripRows
from slowflow_tpu_torch.variational import (fused_data, fused_solve,
                                            fused_warp, terms)
from slowflow_tpu_torch.variational.params import MultiFrameParams

P = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0, rho=(1.0, 1.0),
                     omega=(0.0, 2.0), niter_solver=30, smoothing=1)
TOL = 1e-4
MODES = [("assembly", False), ("assembly", True), ("occ", False),
         ("occ", True), ("occ_assembly", True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _solve_inputs(b, h, w, seed, device):
    rng = np.random.default_rng(seed)
    uu, vv, b1, b2 = rng.normal(0, 1, (4, b, h, w))
    dpsis = 0.5 * rng.random((b, h, w))
    a11, a22 = 1 + rng.random((2, b, h, w))
    a12 = 0.3 * rng.normal(0, 1, (b, h, w))
    du, dv = rng.normal(0, 0.1, (2, b, h, w))
    wh, wv = 0.5 * rng.random((2, b, h, w)) + 0.05
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv, wh, wv)]


SHAPES = [(1, 45, 70), (3, 37, 5), (2, 9, 1), (1, 1, 33), (5, 31, 63),
          (16, 270, 480)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("iterations", [0, 1, 30])
def test_solve_step_kernel_edge_shapes(cuda_device, shape, iterations):
    t = _solve_inputs(*shape, 40, cuda_device)
    _, _, reg = P.penalties()
    for method in (0, 1, 2):
        for given, with_change in ((False, True), (True, True),
                                   (True, False)):
            du, dv = (t[8], t[9]) if given else (None, None)
            kw = dict(alpha=P.alpha, reg_pen=reg, method=method,
                      iterations=iterations, omega=1.9,
                      with_change=with_change)
            got = fused_solve.solve_step(*t[:8], du, dv, **kw)
            want = fused_solve.solve_step_ref(*t[:8], du, dv, **kw)
            for g, w in zip(got, want):
                assert _rel(g.cpu(), w.cpu()) <= TOL, (method, given)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("iterations", [0, 1, 30])
def test_sor_kernel_edge_shapes(cuda_device, shape, iterations):
    t = _solve_inputs(*shape, 41, cuda_device)
    system = (t[8], t[9], *t[3:8], t[10], t[11])
    before = [x.clone() for x in system]
    got = solver_pallas.sor_coupled_rb_pallas(*system, iterations=iterations,
                                              omega=1.9)
    want = solver.sor_coupled_rb(*system, iterations=iterations, omega=1.9)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu()) <= TOL
    for x, y in zip(system, before):
        assert torch.equal(x, y)   # the inputs are read only


@pytest.mark.cuda
def test_solve_step_plans_and_repeatable_sums(cuda_device):
    """4 x 270 x 480 fits the blocks' shared memory, 16 x 270 x 480 takes
    the grouped path, 4 groups; the change sums are bit-identical from run
    to run on both paths."""
    assert fused_solve.solve_plan(4, 270, 480).resident
    plan = fused_solve.solve_plan(16, 270, 480)
    assert (plan.regime, plan.groups) == ("grouped", 4)
    _, _, reg = P.penalties()
    kw = dict(alpha=P.alpha, reg_pen=reg, method=1, iterations=30,
              omega=1.9, with_change=True)
    for shape in ((4, 270, 480), (16, 270, 480)):
        t = _solve_inputs(*shape, 42, cuda_device)
        first = fused_solve.solve_step(*t[:8], None, None, **kw)
        again = fused_solve.solve_step(*t[:8], None, None, **kw)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _k2_inputs(b, h, w, s, seed, device):
    rng = np.random.default_rng(seed)
    seq = rng.random((b, 2 * s - 1, 3, h, w)) * 255
    flow = np.clip(rng.normal(0, 1.5, (2, b, h, w)) + 0.5, -3, 3)
    occ = rng.integers(-1, 2, (b, h, w))
    du, dv = rng.normal(0, 0.2, (2, b, h, w))
    cw = 0.5 + rng.random((b, 3, h, w))
    return [torch.tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (seq, flow[0], flow[1], occ, du, dv, cw)]


def _params(s):
    return MultiFrameParams(**{**P.__dict__, "S": s,
                               "rho": (1.0, 0.5, 0.25)[:s - 1],
                               "omega": (0.0, 2.0, 1.0)[:s - 1]})


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(3, 131, 237), (2, 17, 9), (1, 5, 41)],
                         ids=lambda s: "x".join(map(str, s)))
def test_assembly_kernels_odd_shapes(cuda_device, s, shape):
    p = _params(s)
    seq, wx, wy, occ, du, dv, cw = _k2_inputs(*shape, s, 43, cuda_device)
    warped, masks = warp_shift.warp_stack_ref(seq, wx, wy, p.ref)
    raw = terms.succ_mask(masks, p.ref)
    gated = terms.gate_masks(raw, occ, p)
    for mode, zero_duv in MODES:
        kw = dict(mode=mode, zero_duv=zero_duv)
        args = (seq, wx, wy, occ, du, dv, cw, p)
        for g, w in zip(fused_warp.warp_assemble(*args, **kw),
                        fused_warp.warp_assemble_ref(*args, **kw)):
            assert _rel(g.cpu(), w.cpu()) <= TOL, ("K2", mode, zero_duv)
        args = (warped, gated if mode == "assembly" else raw, du, dv, cw, p)
        for g, w in zip(fused_data.fused_data_system(*args, **kw),
                        fused_data.fused_data_system_ref(*args, **kw)):
            assert _rel(g.cpu(), w.cpu()) <= TOL, ("K3", mode, zero_duv)


# K3's tiles at every image edge: 40 x 100 has rows 16-byte aligned (W % 4
# == 0), so interior tiles take 16-byte copies and the left / right edge
# tiles the clamped 4-byte ones; 37 x 70 and 50 x 33 are unaligned; 3 x 64
# is shorter than the halo.
EDGE_SHAPES = [(2, 40, 100), (1, 37, 70), (1, 3, 64), (1, 50, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_data_kernel_tiles_at_every_edge(cuda_device, s, shape):
    p = _params(s)
    seq, wx, wy, occ, du, dv, cw = _k2_inputs(*shape, s, 44, cuda_device)
    warped, masks = warp_shift.warp_stack_ref(seq, wx, wy, p.ref)
    raw = terms.succ_mask(masks, p.ref)
    gated = terms.gate_masks(raw, occ, p)
    for mode, zero_duv in MODES:
        kw = dict(mode=mode, zero_duv=zero_duv)
        args = (warped, gated if mode == "assembly" else raw, du, dv, cw, p)
        for g, w in zip(fused_data.fused_data_system(*args, **kw),
                        fused_data.fused_data_system_ref(*args, **kw)):
            assert _rel(g.cpu(), w.cpu()) <= TOL, (mode, zero_duv)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(3, 131, 237), (2, 40, 100), (1, 5, 41)],
                         ids=lambda s: "x".join(map(str, s)))
def test_stack_kernels_match_merged_kernel_odd_shapes(cuda_device, s, shape):
    """K3 on K4's stack (succ_mask, gated in assembly mode) against K2."""
    p = _params(s)
    seq, wx, wy, occ, du, dv, cw = _k2_inputs(*shape, s, 45, cuda_device)
    warped, masks = warp_shift.warp_stack(seq, wx, wy, p.ref)
    raw = terms.succ_mask(masks, p.ref)
    for mode in ("assembly", "occ"):
        mask = terms.gate_masks(raw, occ, p) if mode == "assembly" else raw
        got = fused_data.fused_data_system(warped, mask, du, dv, cw, p,
                                           mode=mode)
        want = fused_warp.warp_assemble(seq, wx, wy, occ, du, dv, cw, p,
                                        mode=mode)
        for g, w in zip(got, want):
            assert _rel(g.cpu(), w.cpu()) <= TOL, mode


# K4 / K6's entry: W under and not a multiple of the kernel's vector width,
# W % 4 == 0 across two column tiles, one channel, B = 1, F = 16.
WARP_SHAPES = [(1, 16, 3, 19, 37), (1, 5, 3, 23, 3), (2, 5, 3, 40, 132),
               (3, 3, 1, 7, 1)]
MOTIONS = {"0.3px": 0.3, "20px": 20.0, "outside": 5000.0}


def _warp_inputs(b, f, c, h, w, motion, seed, device):
    rng = np.random.default_rng(seed)
    seq = rng.random((b, f, c, h, w)) * 255
    wx = MOTIONS[motion] * rng.choice([-1, 1], (b, h, w)) \
        * (1 + 0.1 * rng.random((b, h, w)))
    wy = MOTIONS[motion] * rng.uniform(-1, 1, (b, h, w))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (seq, wx, wy)]


@pytest.mark.cuda
@pytest.mark.parametrize("identity", ["ref", "none"])
@pytest.mark.parametrize("motion", list(MOTIONS))
@pytest.mark.parametrize("shape", WARP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_warp_stack_kernel_bit_equal(cuda_device, shape, motion, identity):
    """K4's entry (frame ref copied) and K6's (every frame warped, any
    factors) equal their twins bit for bit."""
    seq, wx, wy = _warp_inputs(*shape, motion, 46, cuda_device)
    f = shape[1]
    ref = f // 2
    if identity == "ref":
        got = warp_shift.warp_stack(seq, wx, wy, ref)
        want = warp_shift.warp_stack_ref(seq, wx, wy, ref)
    else:
        factors = [0.75 * (k - ref) for k in range(f)]
        got = warp_pallas.warp_stack_pallas(seq, wx, wy, factors)
        want = warp_pallas.warp_stack_pallas_ref(seq, wx, wy, factors)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("motion", list(MOTIONS))
def test_warp_bilinear_entry_without_mask_bit_equal(cuda_device, motion):
    seq, wx, wy = _warp_inputs(2, 1, 3, 21, 45, motion, 47, cuda_device)
    got, mask = warp_pallas.warp_bilinear_pallas(seq[:, 0], wx, wy, 1.5,
                                                 with_mask=False)
    assert mask is None
    want, _ = warp_pallas.warp_bilinear(seq[:, 0], wx, wy, 1.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _plan_model(device):
    props = torch.cuda.get_device_properties(device)
    return lambda *shape: fused_solve.plan_model(
        *shape, nsm=props.multi_processor_count,
        optin=props.shared_memory_per_block_optin)


@pytest.mark.cuda
def test_solve_plan_matches_model(cuda_device):
    """The kernel library's plan equals the Python mirror over every regime."""
    model = _plan_model(cuda_device)
    regimes = set()
    for b in (1, 2, 3, 4, 5, 7, 8, 16, 40, 133):
        for h, w in ((270, 480), (271, 479), (176, 314), (540, 960),
                     (1080, 1920), (1207, 3840), (2160, 3840), (9, 1),
                     (1, 33)):
            got = fused_solve.solve_plan(b, h, w)
            assert got == model(b, h, w), (b, h, w)
            regimes.add(got.regime)
    assert regimes == set(fused_solve.REGIMES)


# (shape, regime): the grouped path in even and uneven groups and at odd H
# and W, one jet a group at 540 x 960, and the row-streamed path at 1080p
# (even and odd H and W), where the jets alone stream too but in other bands
REGIME_SHAPES = [((40, 270, 480), "grouped"), ((8, 270, 480), "grouped"),
                 ((7, 270, 480), "grouped"), ((9, 271, 479), "grouped"),
                 ((3, 540, 960), "grouped"),
                 ((2, 1080, 1920), "row-streamed"),
                 ((2, 1081, 1921), "row-streamed")]


def _per_jet(call, planes, b):
    """`call` on each jet alone, the outputs stacked again."""
    outs = [call([None if x is None else x[i:i + 1] for x in planes])
            for i in range(b)]
    return [torch.cat(parts) for parts in zip(*outs)]


def _regime_calls(t, iterations, given, rows=None):
    """K1 (with sums) and K5 on the planes `t` of _solve_inputs."""
    _, _, reg = P.penalties()
    kw = dict(alpha=P.alpha, reg_pen=reg, method=1, iterations=iterations,
              omega=1.9, with_change=True)

    def k1(x, rows=rows, ref=False):
        fn = fused_solve.solve_step_ref if ref else fused_solve.solve_step
        return fn(*x[:8], *(x[8:10] if given else (None, None)), **kw,
                  rows=rows)

    def k5(x, rows=rows, ref=False):
        fn = solver.sor_coupled_rb if ref else \
            solver_pallas.sor_coupled_rb_pallas
        return fn(x[8], x[9], *x[3:8], x[10], x[11], iterations=iterations,
                  omega=1.9, rows=rows)
    return k1, k5


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [0, 1, 30])
@pytest.mark.parametrize("case", REGIME_SHAPES,
                         ids=lambda c: "x".join(map(str, c[0])))
def test_solve_regimes_bitwise_per_jet(cuda_device, case, iterations):
    """K1 and K5 on the grouped and row-streamed paths: du / dv bitwise
    the jets solved one at a time (B = 1: resident, or row-streamed in
    other bands), within the twin's bound; K1's sums within it too and
    bit-identical over 20 runs."""
    shape, regime = case
    b = shape[0]
    assert fused_solve.solve_plan(*shape).regime == regime
    t = _solve_inputs(*shape, 48, cuda_device)
    for given in (False, True):
        k1, k5 = _regime_calls(t, iterations, given)
        for name, call in (("K1", k1), ("K5", k5)):
            got = call(t)
            alone = _per_jet(call, t, b)
            for g, a in zip(got[:2], alone[:2]):
                assert torch.equal(g, a), (name, given)
            want = call(t, ref=True)
            for g, w in zip(got, want):
                assert _rel(g.cpu(), w.cpu()) <= TOL, (name, given)
        first = k1(t)[2]
        for _ in range(20):
            assert torch.equal(k1(t)[2], first)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [REGIME_SHAPES[2], REGIME_SHAPES[6]],
                         ids=lambda c: "x".join(map(str, c[0])))
def test_solve_regimes_strip_rows(cuda_device, case):
    """Strip windows with odd first image rows and own-row ranges on both
    new paths: bitwise the windows solved one at a time, within the twin's
    bound."""
    shape, regime = case
    b, h, w = shape
    assert fused_solve.solve_plan(*shape).regime == regime
    t = _solve_inputs(*shape, 49, cuda_device)
    first = [2 * e + 1 for e in range(b)]
    table = torch.tensor([[f, 3 - e % 2, h - 2 - e % 3] for e, f in
                          enumerate(first)], dtype=torch.int32,
                         device=cuda_device)
    rows = StripRows(table, h + 2 * b + 1)
    k1, k5 = _regime_calls(t, 30, True, rows)
    for name, call in (("K1", k1), ("K5", k5)):
        got = call(t)
        alone = [call([x[e:e + 1] for x in t],
                      rows=StripRows(table[e:e + 1].contiguous(),
                                     rows.img_h)) for e in range(b)]
        for i, g in enumerate(got[:2]):
            assert torch.equal(g, torch.cat([a[i] for a in alone])), name
        for g, w in zip(got, call(t, ref=True)):
            assert _rel(g.cpu(), w.cpu()) <= TOL, name


@pytest.mark.cuda
def test_solve_grouped_call_replays_in_a_graph(cuda_device):
    """A grouped K1 / K5 call captured in a CUDA graph replays bitwise its
    eager result."""
    t = _solve_inputs(8, 270, 480, 50, cuda_device)
    k1, k5 = _regime_calls(t, 30, True)
    for call in (k1, k5):
        eager = call(t)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call(t)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call(t)
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(out, eager):
            assert torch.equal(o, e)
