#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stage-2 jet solve, its EPIC init and the
stage-1 and standalone EpicFlow CLIs on one GPU.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero without the final line):
  1. print the card (nvidia-smi name, power limit); build the CUDA kernels
     from slowflow_tpu_torch/csrc (one nvcc per source, in parallel) and
     the host Dijkstra of the EPIC init (slowflow_tpu_torch/native, g++),
     and print the build times;
  2. each kernel against its plain PyTorch twin on the card at the bench
     shapes (B=4, S=3, 270x480 and the coarsest level 176x314): K2
     warp_assemble and K3 fused_data in all three modes, K1 solve_step for
     smoothing methods 0/1/2 from zero and from a given increment, K4
     warp_stack at the bench flow and at ~20 px, K5 sor (30 sweeps from a
     nonzero increment), K6's entry warp_stack_pallas (factors -2..2), and
     K3 on K4's stack against K2; K1 and K5 also on their streaming path
     (B=16 at 270x480) and at odd shapes, K5 at stage 1's B=40 x 270x480,
     K2 at an odd shape; relative
     error, time (CUDA events), the least time the card could take for the
     same work (bound), the time of grid_sample on K4's and K6's planes (K4
     and K6's entry must not take more device time than it at the bench
     shape), and each wrapper's CUDA launches and device time in one call
     under torch.profiler; K1 / K5's band plans and K2 / K3 / K4's
     registers, spills and resident blocks per SM (K2 and K3 need 2);
  3. the slice: variational_mt_batched at the bench configuration (bench
     scene of slowflow_tpu_torch/bench_scene.py, 5 levels, 10 alternations x 10 outer x 30 SOR sweeps, occlusion
     reasoning, batch 4) on the merged route and on the stack route with the
     composed solve, each once through the kernels and once through the
     twins, both on the card: wall times, launch counts per route, flow
     recovery error and the kernel-vs-twin agreement; the unfused route
     with the pallas_warp window warp at 2 levels, 2 x 3 iterations,
     through the kernels; then one kernel run of the merged and of the
     stack route under torch.profiler for the device time by kernel and
     the idle share;
  4. the stage-2 CLI (deep_matching 0) on a small synthetic PNG sequence,
     once with the default route and once with the cfg keys
     slow_flow_merge_warp 0, slow_flow_fused_solve 0, slow_flow_pallas_sor 1
     (launch counts must show the stack route and the composed solve);
  5. cli_stage2_epic: the stage-2 CLI with deep_matching 1 (EPIC init, no
     quantil.dat, so matcher radius 50) at the bench configuration on the
     bench scene written as 8-bit PNGs at 270x480, Jets 4, S = 3, -batch 4,
     in this process with the phase timers on: K1 and K2 launched,
     flow_recovery_err_px of jet 0's forward .flo (per frame) <= 0.01, the
     init's own recovery error, matches kept, the per-phase seconds and the
     wall per batch; then the same CLI with deep_matching 0 for the wall
     per batch without the init;
  6. stage1: the stage-1 CLI over 40 samples of 42 frames of the same scene
     at 270x480 (-scale 1.0 -skip 2 -samples 40 -step 1): K5 launched,
     quantil.dat's first value within 10 % of |(1.5, -0.8)| = 1.70 px/frame,
     the batched two-frame solve's time and K5's plan at B = 40;
  7. epicflow_cli: the standalone EpicFlow CLI on one 270x480 pair with
     auto edges and matches and -sintel: exit 0 and the flow recovered.
Prints a JSON line with one entry per kernel (K3's also with its other
modes' times at the bench shape), then
{"ok": true, "device": {...}} as the last line. A detailed record goes to
chiprun_out/chip_smoke.json.

Bounds: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its float32 operations
over 67 TFLOP/s (an H100 SXM's HBM and non-tensor fp32 peaks). Operation
counts per cell are counted from the kernels' sources (an FMA is 2); see
`_work_*`.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import textwrap
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "chiprun_out"      # gitignored; the detailed record lands here
HBM_BYTES_PER_S = 3.35e12           # H100 SXM peaks (NVIDIA data sheet)
FP32_FLOPS = 67e12
FAILURES: list[str] = []
RECORD: dict = {}

# Kernel-vs-twin bounds. nvcc contracts a*b + c into one FMA, so the kernels
# round differently from the twins' separate tensor ops; per-plane errors
# stay ~1e-6 relative. Over the whole slice those last bits feed the robust
# IRLS weights and the ICM test c1 < c0, which can flip a tie and move a few
# pixels by more: hence the median / mean / label-share bounds.
REL_TOL = 1e-4          # per output plane, max|kernel - twin| / max|twin|
FLOW_MEDIAN_TOL = 1e-3  # px
FLOW_MEAN_TOL = 1e-2    # px
LABEL_SHARE_TOL = 0.01  # share of occlusion labels that differ
RECOVERY_TOL = 0.01     # px, |median(wx) - 1.5| on the bench scene
QUANTIL_TOL = 0.10      # relative, stage 1's quantile against |(u, v)|
EPICFLOW_TOL = 0.1      # px, the standalone CLI's interior median flow
BENCH_UV = (1.5, -0.8)  # the bench scene's background motion, px/frame

# kernels each route must launch; every other kernel must stay at zero
ROUTE_KERNELS = {
    "merged": {"warp_assemble", "solve_step"},
    "stack": {"warp_stack", "fused_data", "sor"},
    "unfused": {"warp_stack_pallas", "sor"},
}


def bench_params(**route):
    """bench.py's configuration: cfgs/slow_flow.cfg at 1080p * 0.25; route
    keys (and depth cuts) as keyword overrides."""
    from slowflow_tpu_torch.variational.params import MultiFrameParams

    return MultiFrameParams(**{**dict(
        S=3, alpha=4.0, gamma=6.0, delta=1.0, rho=(1.0, 1.0),
        omega=(0.0, 2.0), layers=5, p_scale=0.9, niter_alter=10,
        niter_outer=10, niter_inner=1, niter_solver=30,
        occlusion_reasoning=True, smoothing=1), **route})


ROUTE_PARAMS = {
    "merged": {},
    "stack": dict(merge_warp=False, fused_solve=False),
    "unfused": dict(pallas_warp=True, fused_solve=False, layers=2,
                    niter_alter=2, niter_outer=3),
}


def twins():
    """multiframe's kernel wrappers -> their plain twins."""
    from slowflow_tpu_torch.core import solver, warp_pallas, warp_shift
    from slowflow_tpu_torch.variational import (fused_data, fused_solve,
                                                fused_warp)

    return {"warp_assemble": fused_warp.warp_assemble_ref,
            "solve_step": fused_solve.solve_step_ref,
            "fused_data_system": fused_data.fused_data_system_ref,
            "warp_stack": warp_shift.warp_stack_ref,
            "warp_stack_pallas": warp_pallas.warp_stack_pallas_ref,
            "sor_coupled_rb_pallas": solver.sor_coupled_rb}


def check(cond: bool, what: str) -> None:
    print(("PASS " if cond else "FAIL ") + what, flush=True)
    if not cond:
        FAILURES.append(what)


def phase(fn):
    """Run one phase; a failure is recorded and later phases still run."""
    name = fn.__name__
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        fn()
    except Exception:
        traceback.print_exc()
        FAILURES.append(f"{name} raised")
    print(f"== {name} took {time.perf_counter() - t0:.1f} s", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple[float, float]:
    d = (got - want).abs().max().item()
    return d / max(want.abs().max().item(), 1e-30), d


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for this work, and which term
    sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# float32 operations per cell, counted from csrc/ (an FMA is 2): K1's
# prologue by smoothing method (weights, 2 RHS adjustments, 2x2 inverse),
# one red-black sweep (each cell updated once), the change sums.
K1_PROLOGUE_OPS = {0: 70, 1: 105, 2: 65}
K1_SWEEP_OPS, K1_SUMS_OPS, K5_PROLOGUE_OPS = 32, 6, 15
# assembly kernels, per pixel: the bilinear warp of one frame (coordinates,
# weights, 3 channels), one on pair's derivatives (Ix, Iy, Iz, Ixx, Ixy,
# Iyy, Ixz, Iyz over 3 channels, the mask), its IRLS assembly (delta +
# gamma terms; the to-reference pair carries the factor products; zero_duv
# drops the linearization) and its occlusion cost.
WARP_OPS, DERIV_OPS, OCC_OPS = 40, 222, 30
ASM_OPS = {"succ": 270, "ref": 350}
ZERO_DUV_SAVES = 36


def _work_solve(b, h, w, method, zero_init, iterations, sums=True):
    n = b * h * w
    nbytes = 4 * n * (8 + (0 if zero_init else 2) + 2) + (8 * b if sums else 0)
    flops = n * (K1_PROLOGUE_OPS[method] + K1_SWEEP_OPS * iterations
                 + (K1_SUMS_OPS if sums else 0))
    return bound(nbytes, flops)


def _work_sor(b, h, w, iterations):
    n = b * h * w
    return bound(4 * n * 11, n * (K5_PROLOGUE_OPS + K1_SWEEP_OPS * iterations))


def _work_assembly(p, b, h, w, mode, zero_duv, warp):
    """K2 (warp=True: reads the window and the flow) or K3 (reads the warped
    window and the mask)."""
    from slowflow_tpu_torch.variational.fused_data import MODES, kernel_params

    f, n, hw = 2 * p.ref + 1, 2 * p.ref, h * w
    n_out = MODES[mode][1]
    planes = 3 * f + 3 + (0 if zero_duv else 2) + n_out
    planes += (2 + (mode == "assembly")) if warp else n
    prm = kernel_params(p)
    on_s, on_r = (prm[15 + 8 * a:15 + 8 * a + n]
                  for a in ((4, 5) if mode == "assembly" else (6, 7)))
    per_pair = {"succ": DERIV_OPS, "ref": DERIV_OPS}
    for kind in per_pair:
        if mode != "occ":
            per_pair[kind] += ASM_OPS[kind] - (ZERO_DUV_SAVES if zero_duv else 0)
        if mode != "assembly":
            per_pair[kind] += OCC_OPS
    ops = (int((on_s != 0).sum()) * per_pair["succ"]
           + int((on_r != 0).sum()) * per_pair["ref"]
           + ((f - 1) * WARP_OPS if warp else 0))
    return bound(4 * b * hw * planes, b * hw * ops)


def _work_warp(b, f, h, w, warped_frames):
    hw = h * w
    return bound(4 * b * hw * (3 * f + 2 + 3 * f + f),
                 b * hw * warped_frames * WARP_OPS)


def _grid_sample(seq, wx, wy, factors) -> dict:
    """One torch.nn.functional.grid_sample call on the same planes (bilinear,
    border padding, align_corners): a yardstick that clamps the coordinate
    rather than each corner and computes no mask. Its time by CUDA events
    (library_ms) and its device time under the profiler
    (library_device_ms)."""
    import torch
    import torch.nn.functional as F

    b, f, c, h, w = seq.shape
    fac = torch.tensor(factors, dtype=torch.float32,
                       device=seq.device).view(1, f, 1, 1)
    xs = torch.arange(w, device=seq.device).view(1, 1, 1, w) + fac * wx[:, None]
    ys = torch.arange(h, device=seq.device).view(1, 1, h, 1) + fac * wy[:, None]
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1],
                       -1).view(b * f, h, w, 2)
    inp = seq.reshape(b * f, c, h, w)

    def call():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    return dict(library_ms=cuda_ms(call),
                library_device_ms=_one_call_profile(call)["device_ms"])


def _kernel_events(prof):
    """The CUDA kernels a torch.profiler run saw (no memcpy / memset)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.events()
            if getattr(ev, "device_type", None) == DeviceType.CUDA
            and not ev.name.startswith(("Memcpy", "Memset"))]


def _one_call_profile(fn, attempts: int = 10) -> dict:
    """CUDA kernel launches and device time of one call of `fn`. The
    profiler now and then delivers no kernel record for a call that ran,
    sometimes for several captures in a row, so one capture proves nothing:
    captures are taken until two agree on a nonzero kernel count, at most
    `attempts`, with a growing pause after each that does not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = _kernel_events(prof)
        agreed = bool(evs) and len(evs) in counts
        counts.append(len(evs))
        if agreed:
            break
        if attempt > 1:
            time.sleep(0.1 * attempt)
    return dict(launches_per_call=len(evs), profile_counts=counts,
                device_ms=sum(ev.time_range.elapsed_us() for ev in evs) / 1e3,
                kernel_names=sorted({ev.name[:80] for ev in evs}))


# ---------------------------------------------------------------- phase 1
def build():
    from slowflow_tpu_torch import kernels

    from slowflow_tpu_torch import native

    t0 = time.perf_counter()
    kernels.build()
    kernels.load()
    RECORD["build_s"] = time.perf_counter() - t0
    print(f"kernels built and loaded in {RECORD['build_s']:.1f} s "
          f"({kernels.library_path().relative_to(HERE)})")
    t0 = time.perf_counter()
    native.load()
    RECORD["native_build_s"] = time.perf_counter() - t0
    print(f"host Dijkstra built and loaded in {RECORD['native_build_s']:.1f}"
          f" s ({native.library_path().relative_to(HERE)})")


# ---------------------------------------------------------------- phase 2
def _k2_inputs(b, h, w, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    seq = rng.random((b, 5, 3, h, w)) * 255
    coarse = rng.normal(0, 1, (b, 2, h // 16 + 2, w // 16 + 2))
    flow = np.kron(coarse, np.ones((16, 16)))[..., :h, :w]
    flow = np.clip(flow * 1.5 + np.array([1.0, -0.5])[None, :, None, None],
                   -3, 3)
    occ = rng.integers(-1, 2, (b, h, w))
    du = rng.normal(0, 0.2, (b, h, w))
    dv = rng.normal(0, 0.2, (b, h, w))
    cw = 0.5 + rng.random((b, 3, h, w))
    arrays = (seq, flow[:, 0], flow[:, 1], occ, du, dv, cw)
    return [torch.tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in arrays]


def _k1_inputs(b, h, w, seed, device):
    """A diagonally dominant system like the assembled ones (a11, a22 > 0)."""
    import torch

    rng = np.random.default_rng(seed)
    uu, vv, b1, b2 = rng.normal(0, 1, (4, b, h, w))
    dpsis = 0.5 * rng.random((b, h, w))
    a11, a22 = 1 + rng.random((2, b, h, w))
    a12 = 0.3 * rng.normal(0, 1, (b, h, w))
    du, dv = rng.normal(0, 0.1, (2, b, h, w))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv)]


def _compare(name, entry_key, kern, twin, what, work=None, library=None):
    """Run kernel and twin once on the same inputs, record the worst
    per-plane relative / absolute error, both times, the bound of `work`,
    the library call's times (`_grid_sample`), and the kernel's launches
    and device time in one call."""
    import torch

    got, want = kern(), twin()
    torch.cuda.synchronize()
    errs = [rel_err(g, t) for g, t in zip(got, want)]
    worst = max(e[0] for e in errs)
    entry = dict(entry_key, rel_err=worst, abs_err=max(e[1] for e in errs),
                 ms=cuda_ms(kern), plain_ms=cuda_ms(twin, 2),
                 **(library or dict(library_ms=None)), **(work or {}),
                 **_one_call_profile(kern))
    RECORD.setdefault("kernels_vs_twins", {}).setdefault(name, []).append(
        entry)
    extra = f", bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})" \
        if work else ""
    if library:
        extra += (f", grid_sample {entry['library_ms']:.3f} ms, device "
                  f"{entry['library_device_ms']:.4f} ms")
    if len(entry["profile_counts"]) > 2:
        extra += f", profiler kernel counts {entry['profile_counts']}"
    check(worst <= REL_TOL,
          f"{what}: rel err {worst:.2e} (per plane: "
          + " ".join(f"{e[0]:.1e}" for e in errs)
          + f"); {entry['ms']:.3f} ms vs twin {entry['plain_ms']:.3f} ms"
          + extra + f"; {entry['launches_per_call']} launches, device "
          f"{entry['device_ms']:.4f} ms")


VARIANTS = (("assembly", False), ("assembly", True), ("occ", False),
            ("occ", True), ("occ_assembly", True))


def kernels_vs_twins():
    """K2 and K1 against their twins (K2 also at an odd shape, K1 also on
    its streaming path and at odd shapes); K1 / K5's band plans and K2 /
    K3's registers and resident blocks."""
    import ctypes

    import torch

    from slowflow_tpu_torch import kernels
    from slowflow_tpu_torch.variational import fused_solve, fused_warp

    dev = torch.device("cuda")
    p = bench_params()
    _, _, reg = p.penalties()
    lib = kernels.load()
    res = (ctypes.c_int * 3)()
    for fn, name in (("sf_warp_assemble_occupancy", "K2"),
                     ("sf_fused_data_occupancy", "K3")):
        for mode, zero_duv in VARIANTS:
            kernels.check(getattr(lib, fn)(
                ("assembly", "occ", "occ_assembly").index(mode),
                int(zero_duv), p.ref, res), fn)
            RECORD.setdefault("resources", {})[
                f"{name} {mode} zero_duv={zero_duv}"] = list(res)
            check(res[0] >= 2, f"{name} {mode} zero_duv={zero_duv}: "
                  f"{res[0]} resident blocks per SM (at least 2)")
            print(f"{name} {mode:12s} zero_duv={zero_duv!s:5}: {res[0]} "
                  f"blocks/SM, {res[1]} registers, {res[2]} B spilled")
    kernels.check(lib.sf_warp_stack_occupancy(res), "sf_warp_stack_occupancy")
    RECORD["resources"]["K4 / K6 warp_stack"] = list(res)
    print(f"K4 / K6 warp_stack: {res[0]} blocks/SM, {res[1]} registers, "
          f"{res[2]} B spilled")
    for shape in ((4, 270, 480), (4, 176, 314), (16, 270, 480)):
        for k5 in (False, True):
            plan = fused_solve.solve_plan(*shape, k5=k5)
            RECORD.setdefault("solve_plans", {})[
                f"{'K5' if k5 else 'K1'} {shape}"] = plan._asdict()
            print(f"{'K5' if k5 else 'K1'} plan at {shape}: {plan}")

    for (b, h, w) in ((4, 270, 480), (4, 176, 314), (3, 131, 237)):
        args = _k2_inputs(b, h, w, 0, dev)
        for mode, zero_duv in VARIANTS:
            kw = dict(mode=mode, zero_duv=zero_duv)
            _compare("warp_assemble", dict(shape=[b, h, w], **kw),
                     lambda: fused_warp.warp_assemble(*args, p, **kw),
                     lambda: fused_warp.warp_assemble_ref(*args, p, **kw),
                     f"K2 {mode:12s} zero_duv={zero_duv!s:5} {b}x{h}x{w}",
                     work=_work_assembly(p, b, h, w, mode, zero_duv, True))

    # bench shapes (resident), B = 16 (streaming), odd shapes, short runs
    cases = [(4, 270, 480, m, p.niter_solver) for m in (0, 1, 2)]
    cases += [(4, 176, 314, m, p.niter_solver) for m in (0, 1, 2)]
    cases += [(16, 270, 480, 1, p.niter_solver), (3, 37, 5, 1, 30),
              (1, 45, 70, 2, 1), (2, 9, 1, 0, 0)]
    for (b, h, w, method, iterations) in cases:
        t = _k1_inputs(b, h, w, 1, dev)
        resident = fused_solve.solve_plan(b, h, w).resident
        for zero_init in (True, False):
            du, dv = (None, None) if zero_init else (t[8], t[9])
            kw = dict(alpha=p.alpha, reg_pen=reg, method=method,
                      iterations=iterations, omega=p.sor_omega,
                      with_change=True)
            _compare("solve_step", dict(shape=[b, h, w], method=method,
                                        zero_init=zero_init,
                                        iterations=iterations,
                                        resident=resident),
                     lambda: fused_solve.solve_step(*t[:8], du, dv, **kw),
                     lambda: fused_solve.solve_step_ref(*t[:8], du, dv, **kw),
                     f"K1 method {method} zero_init={zero_init!s:5} "
                     f"{b}x{h}x{w} x {iterations} sweeps "
                     f"({'resident' if resident else 'streaming'})",
                     work=_work_solve(b, h, w, method, zero_init, iterations))
    check(not fused_solve.solve_plan(16, 270, 480).resident,
          "K1 at 16x270x480 takes the streaming path")

    # the change sums are bit-identical from run to run
    t = _k1_inputs(4, 270, 480, 1, dev)
    kw = dict(alpha=p.alpha, reg_pen=reg, method=1, iterations=p.niter_solver,
              omega=p.sor_omega, with_change=True)
    first = fused_solve.solve_step(*t[:8], None, None, **kw)[2].cpu()
    same = all(torch.equal(
        fused_solve.solve_step(*t[:8], None, None, **kw)[2].cpu(), first)
        for _ in range(20))
    RECORD["k1_sums_bit_identical_20_runs"] = same
    check(same, "K1 change sums bit-identical over 20 runs at 4x270x480")


def route_kernels_vs_twins():
    """K3, K4, K5 and K6's entry against their twins; K3 on K4's stack
    against K2."""
    import torch

    from slowflow_tpu_torch.core import solver_pallas, warp_pallas, warp_shift
    from slowflow_tpu_torch.variational import fused_data, fused_warp, terms

    dev = torch.device("cuda")
    p = bench_params()
    f = 2 * p.ref + 1
    for (h, w) in ((270, 480), (176, 314)):
        seq, wx, wy, occ, du, dv, cw = _k2_inputs(4, h, w, 0, dev)
        shape = [4, h, w]
        warped, masks = warp_shift.warp_stack_ref(seq, wx, wy, p.ref)
        raw = terms.succ_mask(masks, p.ref)
        gated = terms.gate_masks(raw, occ, p)
        for mode, zero_duv in VARIANTS:
            args = (warped, gated if mode == "assembly" else raw, du, dv, cw,
                    p)
            kw = dict(mode=mode, zero_duv=zero_duv)
            _compare("fused_data", dict(shape=shape, **kw),
                     lambda: fused_data.fused_data_system(*args, **kw),
                     lambda: fused_data.fused_data_system_ref(*args, **kw),
                     f"K3 {mode:12s} zero_duv={zero_duv!s:5} {h}x{w}",
                     work=_work_assembly(p, 4, h, w, mode, zero_duv, False))

        k4_factors = tuple(float(k - p.ref) for k in range(f))
        for motion, shift in (("bench", 0.0), ("20px", 20.0)):
            fx, fy = wx + shift, wy - 0.45 * shift
            _compare("warp_stack", dict(shape=shape, motion=motion),
                     lambda: warp_shift.warp_stack(seq, fx, fy, p.ref),
                     lambda: warp_shift.warp_stack_ref(seq, fx, fy, p.ref),
                     f"K4 warp_stack {motion:5s} {h}x{w}",
                     work=_work_warp(4, f, h, w, f - 1),
                     library=_grid_sample(seq, fx, fy, k4_factors))

        factors = (-2.0, -1.0, 0.0, 1.0, 2.0)
        _compare("warp_stack_pallas", dict(shape=shape, factors=factors),
                 lambda: warp_pallas.warp_stack_pallas(seq, wx, wy, factors),
                 lambda: warp_pallas.warp_stack_pallas_ref(seq, wx, wy,
                                                           factors),
                 f"K6 warp_stack_pallas factors -2..2 {h}x{w}",
                 work=_work_warp(4, len(factors), h, w, len(factors)),
                 library=_grid_sample(seq, wx, wy, factors))

        # K3 on K4's stack (succ_mask, gated for assembly) against K2
        kwarped, kmasks = warp_shift.warp_stack(seq, wx, wy, p.ref)
        kraw = terms.succ_mask(kmasks, p.ref)
        for mode in ("assembly", "occ"):
            mask = terms.gate_masks(kraw, occ, p) if mode == "assembly" \
                else kraw
            _compare("stack_vs_merged", dict(shape=shape, mode=mode),
                     lambda: fused_data.fused_data_system(
                         kwarped, mask, du, dv, cw, p, mode=mode),
                     lambda: fused_warp.warp_assemble(
                         seq, wx, wy, occ, du, dv, cw, p, mode=mode),
                     f"K3 on K4's stack vs K2 {mode:8s} {h}x{w}")

    # K4 and K6's entry against grid_sample on the same planes, at the bench
    # shape, by device time (the CUDA-event time of a ~0.03 ms kernel
    # includes its wrapper's host time)
    for name in ("warp_stack", "warp_stack_pallas"):
        for r in RECORD["kernels_vs_twins"][name]:
            if r["shape"] == [4, 270, 480]:
                check(r["device_ms"] <= r["library_device_ms"],
                      f"{name} {r.get('motion', r.get('factors'))}: device "
                      f"{r['device_ms']:.4f} ms <= grid_sample's "
                      f"{r['library_device_ms']:.4f} ms (CUDA events "
                      f"{r['ms']:.4f} vs {r['library_ms']:.4f} ms)")

    for (b, h, w) in ((4, 270, 480), (4, 176, 314), (16, 270, 480),
                      (40, 270, 480)):
        t = _k1_inputs(b, h, w, 2, dev)
        rng = np.random.default_rng(3)
        wh, wv = (torch.tensor(0.5 * rng.random((b, h, w)) + 0.05,
                               dtype=torch.float32, device=dev)
                  for _ in range(2))
        system = (t[8], t[9], *t[3:8], wh, wv)   # du, dv nonzero
        kw = dict(iterations=p.niter_solver, omega=p.sor_omega)
        _compare("sor", dict(shape=[b, h, w], iterations=p.niter_solver),
                 lambda: solver_pallas.sor_coupled_rb_pallas(*system, **kw),
                 lambda: solver_pallas.sor_coupled_rb(*system, **kw),
                 f"K5 sor {p.niter_solver} sweeps from du, dv != 0 "
                 f"{b}x{h}x{w}", work=_work_sor(b, h, w, p.niter_solver))


# ---------------------------------------------------------------- phase 3
def _bench_scene(b, h, w, device):
    import torch

    from slowflow_tpu_torch.bench_scene import moving_sequence

    return torch.tensor(np.stack([moving_sequence(5, h, w, 1.5 + 0.2 * s,
                                                  -0.8, seed=s)
                                  for s in range(b)]), device=device)


def _check_launches(route, counts, what):
    used = {k for k, v in counts.items() if v > 0}
    check(used == ROUTE_KERNELS[route],
          f"{what} launched {sorted(used)}; the {route} route launches "
          f"{sorted(ROUTE_KERNELS[route])} and nothing else")


def _slice(route, with_twins=True):
    """variational_mt_batched on one route at full width, through the
    kernels (and through the twins), on the card."""
    import torch

    from slowflow_tpu_torch import kernels
    from slowflow_tpu_torch.variational import multiframe

    dev = torch.device("cuda")
    p = bench_params(**ROUTE_PARAMS[route])
    check(p.route().assembly == route, f"{route} params resolve to "
          f"{p.route()}")
    b, h, w = 4, 270, 480
    seq = _bench_scene(b, h, w, dev)
    zero = torch.zeros((b, h, w), device=dev)

    def solve():
        out = multiframe.variational_mt_batched(zero, zero, seq, p,
                                                device=dev)
        torch.cuda.synchronize()
        return out

    def timed():
        solve()                                   # warm-up
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = solve()
        wall = time.perf_counter() - t0
        return out, wall, dict(kernels.LAUNCHES)

    (kwx, kwy, kocc), k_wall, k_counts = timed()
    err = abs(float(kwx[0, 8:-8, 8:-8].median()) - 1.5)
    rec = dict(route=str(p.route()), batch=b, height=h, width=w,
               layers=p.layers, niter_alter=p.niter_alter,
               niter_outer=p.niter_outer, kernel_wall_s=k_wall,
               kernel_counts=k_counts, flow_recovery_err_px=err,
               jets_per_s=b / k_wall)
    RECORD.setdefault("slices", {})[route] = rec
    print(f"{route} slice ({p.layers} levels, {p.niter_alter} x "
          f"{p.niter_outer}) wall per batch of {b}: kernels {k_wall:.3f} s "
          f"({b / k_wall:.3f} jets/s); flow_recovery_err_px {err:.5f}")
    print(f"launch counts: kernels {k_counts}")
    check(bool(torch.isfinite(kwx).all() & torch.isfinite(kwy).all()),
          f"{route} slice flow is finite")
    _check_launches(route, k_counts, f"{route} kernel run")
    if not with_twins:
        return
    with contextlib.ExitStack() as stack:
        for name, fn in twins().items():
            stack.enter_context(mock.patch.object(multiframe, name, fn))
        (twx, twy, tocc), t_wall, t_counts = timed()
    d = torch.hypot(kwx - twx, kwy - twy)
    med, mean = float(d.median()), float(d.mean())
    labels = float((kocc != tocc).float().mean())
    rec.update(twin_wall_s=t_wall, twin_counts=t_counts,
               flow_diff_median_px=med, flow_diff_mean_px=mean,
               flow_diff_max_px=float(d.max()), label_share_differ=labels)
    print(f"{route} slice twins {t_wall:.3f} s; launch counts {t_counts}")
    check(all(v == 0 for v in t_counts.values()),
          f"{route} twin run launched no kernel")
    check(err <= RECOVERY_TOL, f"{route} flow_recovery_err_px {err:.5f} <= "
          f"{RECOVERY_TOL}")
    check(med <= FLOW_MEDIAN_TOL and mean <= FLOW_MEAN_TOL,
          f"{route} kernel vs twin flow |d|: median {med:.2e} px, mean "
          f"{mean:.2e} px, max {float(d.max()):.2e} px")
    check(labels <= LABEL_SHARE_TOL,
          f"{route} kernel vs twin occlusion labels differ on {labels:.4%}")


def slice_merged():
    _slice("merged")


def slice_stack_composed():
    _slice("stack")


def slice_unfused_pallas_warp():
    _slice("unfused", with_twins=False)


def _profile(route):
    """One kernel-route slice run under torch.profiler: device time by
    kernel and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from slowflow_tpu_torch.variational import multiframe

    dev = torch.device("cuda")
    b, h, w = 4, 270, 480
    seq = _bench_scene(b, h, w, dev)
    zero = torch.zeros((b, h, w), device=dev)
    p = bench_params(**ROUTE_PARAMS[route])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        multiframe.variational_mt_batched(zero, zero, seq, p, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, launches = {}, {}
    for ev in _kernel_events(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us() / 1e3
        launches[ev.name] = launches.get(ev.name, 0) + 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # the profiler stretches the wall time: the idle share is also taken
    # against the same route's unprofiled kernel run
    unprofiled = RECORD.get("slices", {}).get(route, {}).get("kernel_wall_s")
    RECORD.setdefault("profiles", {})[route] = dict(
        wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=1 - busy / (wall * 1e3),
        idle_share_unprofiled=None if unprofiled is None
        else 1 - busy / (unprofiled * 1e3), top_kernels_ms=top,
        kernel_launches=sum(launches.values()),
        top_launches={k: launches[k] for k, _ in top})
    print(f"profiled {route} slice: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{sum(launches.values())} CUDA kernel launches")
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {launches[name]:6d} x  {name[:90]}")
    check(busy > 0, f"profiler saw device time on the {route} route")


def slice_profiles():
    for route in ("merged", "stack"):
        _profile(route)


# ---------------------------------------------------------------- phase 4
def cli_stage2():
    u, v, h, w, pad = 1.0, 0.5, 72, 96, 24
    rng = np.random.default_rng(7)
    base = rng.random((h + 2 * pad, w + 2 * pad, 3)) * 255
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        seq_dir = tmp / "seq"
        seq_dir.mkdir()
        from PIL import Image

        yy, xx = np.mgrid[0:h, 0:w]
        for f in range(6):
            xs, ys = xx + pad - f * u, yy + pad - f * v
            x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
            fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
            img = (base[y0, x0] * (1 - fx) * (1 - fy)
                   + base[y0, x0 + 1] * fx * (1 - fy)
                   + base[y0 + 1, x0] * (1 - fx) * fy
                   + base[y0 + 1, x0 + 1] * fx * fy)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                seq_dir / f"frame_{f:03d}.png")
        base_cfg = textwrap.dedent(f"""\
        file\t{seq_dir}/frame_%03i.png
        Jets\t2
        start\t2
        max_fps\t40
        ref_fps\t20
        jet_fps\t40
        adaptive\t0
        16bit\t0
        raw\t0
        scale\t1.0
        deep_matching\t0
        slow_flow_S\t2
        slow_flow_layers\t2
        slow_flow_p_scale\t0.8
        slow_flow_occlusion_reasoning\t1
        slow_flow_niter_alter\t2
        slow_flow_niter_outer\t4
        slow_flow_niter_solver\t20
        """)
        cfg = tmp / "slow_flow.cfg"
        cfg.write_text(base_cfg + f"output\t{tmp}/sf_out\n")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "slowflow_tpu_torch.cli.slow_flow",
             str(cfg), "-batch", "2"], cwd=HERE, capture_output=True,
            text=True, timeout=600)
        print(proc.stdout[-1500:], proc.stderr[-3000:], sep="\n")
        check(proc.returncode == 0,
              f"CLI exit code {proc.returncode} "
              f"({time.perf_counter() - t0:.1f} s)")
        RECORD["cli"] = _cli_flows(tmp / "sf_out", u, v, "CLI")

        # the route keys through the CLI's own parameter parsing, in this
        # process so the launch counts can be read
        from slowflow_tpu_torch import kernels
        from slowflow_tpu_torch.cli.slow_flow import main as cli_main

        cfg = tmp / "slow_flow_routes.cfg"
        cfg.write_text(base_cfg + f"output\t{tmp}/sf_routes\n"
                       "slow_flow_merge_warp\t0\nslow_flow_fused_solve\t0\n"
                       "slow_flow_pallas_sor\t1\n")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_main([str(cfg), "-batch", "2"])
        counts = dict(kernels.LAUNCHES)
        check(rc == 0, f"CLI with route keys: exit code {rc} "
              f"({time.perf_counter() - t0:.1f} s), launches {counts}")
        _check_launches("stack", counts, "CLI with route keys")
        RECORD["cli_route_keys"] = dict(
            launches=counts,
            flows=_cli_flows(tmp / "sf_routes", u, v, "CLI with route keys"))


def _cli_flows(out, u, v, what):
    inner = (slice(12, -12), slice(12, -12))
    flows = {}
    for name, sign in (("frame_002.flo", 1), ("frame_003.flo", 1),
                       ("frame_003_back.flo", -1)):
        path = out / name
        if not path.exists():
            check(False, f"{what} wrote {name}")
            continue
        from slowflow_tpu_torch.io import read_flo

        flow = read_flo(path)[inner]
        mu, mv = float(flow[..., 0].mean()), float(flow[..., 1].mean())
        flows[name] = (mu, mv)
        check(abs(mu - sign * u) <= 0.1 and abs(mv - sign * v) <= 0.1,
              f"{what} {name}: interior mean ({mu:.3f}, {mv:.3f}) vs "
              f"({sign * u}, {sign * v})")
    return flows


# ------------------------------------------------------------- phases 5-7
def _write_scene_pngs(seq_dir: Path, n: int, h: int = 270, w: int = 480):
    """The bench scene (background (1.5, -0.8) px/frame) as 8-bit PNGs
    frame_000.png ... frame_<n-1>.png."""
    from PIL import Image

    from slowflow_tpu_torch.bench_scene import moving_sequence

    seq_dir.mkdir(parents=True)
    frames = moving_sequence(n, h, w, *BENCH_UV, seed=0)
    for f, img in enumerate(frames):
        Image.fromarray(np.clip(np.round(np.moveaxis(img, 0, -1)), 0, 255)
                        .astype(np.uint8)).save(seq_dir / f"frame_{f:03d}.png")


@contextlib.contextmanager
def _phase_timers():
    """The port's phase timers on (SF_PROF=1), starting from zero; the CLIs'
    own report (which would reset them) is silenced."""
    from slowflow_tpu_torch.cli import slow_flow
    from slowflow_tpu_torch.utils import phases

    was = phases.ENABLED
    phases.ENABLED = True
    phases.reset()
    try:
        with mock.patch.object(slow_flow, "phase_report", lambda: None):
            yield phases
    finally:
        phases.ENABLED = was
        phases.reset()


# the stage-2 CLI's phases printed per batch: staging, preprocess, matches,
# the two distance transforms (device part inside), seed graph, Dijkstra,
# fits, waiting for the init, the solve, the whole batch
EPIC_PHASES = ("sf.stage_window8", "sf.preprocess_frames", "sf.matches",
               "sf.epic", "epic.prefilter_dt", "epic.main_dt",
               "epic.dt_device", "epic.seed_graph", "epic.dijkstra",
               "epic.prefilter_fit", "epic.fit_la", "epic.apply_la",
               "sf.epic_post", "sf.init_wait", "sf.solve", "sf.batch")


def _stage2_cfg(seq_dir: Path, out: Path, deep_matching: int) -> str:
    """The bench configuration through the CLI's cfg keys: 5 levels at
    p_scale 0.9, 10 alternations x 10 outer x 30 SOR sweeps, occlusion on,
    S = 3, 4 jets at the frame rate of the frames."""
    return textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{out}
    Jets\t4
    start\t2
    max_fps\t40
    ref_fps\t20
    jet_fps\t40
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t{deep_matching}
    slow_flow_S\t3
    slow_flow_layers\t5
    slow_flow_p_scale\t0.9
    slow_flow_niter_alter\t10
    slow_flow_niter_outer\t10
    slow_flow_niter_solver\t30
    slow_flow_occlusion_reasoning\t1
    slow_flow_smoothing\t1
    """)


def cli_stage2_epic():
    import torch

    from slowflow_tpu_torch import kernels
    from slowflow_tpu_torch.cli import slow_flow
    from slowflow_tpu_torch.io import read_flo

    steps = 2                              # S - 1
    rec = RECORD.setdefault("cli_stage2_epic", {})
    slow_flow_matcher = slow_flow.grid_matches_batched
    slow_flow_solve = slow_flow.variational_mt_batched
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        _write_scene_pngs(tmp / "seq", 1 + 6 * steps)
        for dm in (1, 0):
            cfg = tmp / f"dm{dm}.cfg"
            cfg.write_text(_stage2_cfg(tmp / "seq", tmp / f"out{dm}", dm))
            kept, inits = [], []

            def matcher(*args, **kw):
                out = slow_flow_matcher(*args, **kw)
                kept.extend(len(m) for m in out)
                return out

            def solve(wx0, wy0, *args, **kw):
                inits.append(float(wx0[0, 8:-8, 8:-8].median()))
                return slow_flow_solve(wx0, wy0, *args, **kw)

            with _phase_timers() as phases, \
                    mock.patch.object(slow_flow, "grid_matches_batched",
                                      matcher), \
                    mock.patch.object(slow_flow, "variational_mt_batched",
                                      solve):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                rc = slow_flow.main([str(cfg), "-batch", "4"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(kernels.LAUNCHES)
                totals = phases.totals()
            flow = read_flo(tmp / f"out{dm}" / "frame_002.flo")
            err = abs(float(np.median(flow[8:-8, 8:-8, 0])) / steps
                      - BENCH_UV[0])
            n_batch = totals.get("sf.batch", (0.0, 0))[1]
            r = dict(rc=rc, wall_s=wall, launches=counts,
                     flow_recovery_err_px=err, batches=n_batch,
                     phases={k: v for k, v in totals.items()},
                     wall_per_batch_s=totals["sf.batch"][0] / max(n_batch, 1),
                     solve_per_batch_s=totals["sf.solve"][0] / max(n_batch, 1))
            if dm:
                r.update(matches_kept=kept, init_recovery_err_px=abs(
                    inits[0] - BENCH_UV[0]) if inits else None)
            rec["deep_matching_1" if dm else "deep_matching_0"] = r
            what = f"CLI stage 2, deep_matching {dm}"
            check(rc == 0, f"{what}: exit code {rc} ({wall:.1f} s)")
            check(counts["solve_step"] > 0 and counts["warp_assemble"] > 0,
                  f"{what}: launches {counts} (K1 solve_step and K2 "
                  "warp_assemble)")
            check(err <= RECOVERY_TOL, f"{what}: flow_recovery_err_px of jet"
                  f" 0's forward .flo per frame {err:.5f} <= {RECOVERY_TOL}")
            print(f"{what}: {n_batch} batches of 4 jets, wall per batch "
                  f"{r['wall_per_batch_s']:.3f} s (solve "
                  f"{r['solve_per_batch_s']:.3f} s); merged slice of phase 3"
                  f" {RECORD.get('slices', {}).get('merged', {}).get('kernel_wall_s')} s")
            if dm:
                print(f"  EPIC init recovery error {r['init_recovery_err_px']}"
                      f" px; matches kept per jet {kept}")
                for name in EPIC_PHASES:
                    sec, n = totals.get(name, (0.0, 0))
                    print(f"  {name:<24} {sec:8.3f} s  x{n:<3} "
                          f"{sec / max(n_batch, 1):8.3f} s per batch")
                check(bool(kept) and min(kept) > 100,
                      f"{what}: the matcher kept {kept} matches per jet")


def stage1():
    import torch

    from slowflow_tpu_torch import kernels
    from slowflow_tpu_torch.cli import adaptive_fr
    from slowflow_tpu_torch.variational import fused_solve

    plan = fused_solve.solve_plan(40, 270, 480, k5=True)
    rec = RECORD.setdefault("stage1", {"k5_plan_b40": plan._asdict()})
    print(f"K5 plan at (40, 270, 480): {plan}")
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        _write_scene_pngs(tmp / "seq", 42)
        with _phase_timers() as phases:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = adaptive_fr.main([
                "-path", str(tmp), "-folder", "seq",
                "-format", "frame_%03i.png", "-scale", "1.0", "-skip", "2",
                "-samples", "40", "-step", "1", "-start", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
            totals = phases.totals()
        qf = tmp / "seq" / "quantil.dat"
        values = [float(x) for x in qf.read_text().split()] \
            if qf.exists() else []
    target = float(np.hypot(*BENCH_UV))
    rec.update(rc=rc, wall_s=wall, launches=counts, quantil=values,
               phases={k: v for k, v in totals.items()})
    check(rc == 0, f"stage 1: exit code {rc} ({wall:.1f} s)")
    check(counts["sor"] > 0, f"stage 1: launches {counts} (K5 sor)")
    check(bool(values) and abs(values[0] - target) <= QUANTIL_TOL * target,
          f"stage 1: quantil.dat {values} vs |(u, v)| = {target:.3f}")
    for name in ("af.read_frames", "af.preprocess", "af.matches", "af.epic",
                 "af.twoframe", "epic.dt_device", "epic.seed_graph",
                 "epic.dijkstra"):
        sec, n = totals.get(name, (0.0, 0))
        print(f"  {name:<20} {sec:8.3f} s  x{n}")


def epicflow_cli():
    from slowflow_tpu_torch.cli import epicflow
    from slowflow_tpu_torch.io import read_flo

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        tmp = Path(tmp)
        _write_scene_pngs(tmp / "seq", 2)
        out = tmp / "pair.flo"
        t0 = time.perf_counter()
        rc = epicflow.main([str(tmp / "seq" / "frame_000.png"),
                            str(tmp / "seq" / "frame_001.png"), "auto",
                            "auto", str(out), "-sintel"])
        wall = time.perf_counter() - t0
        flow = read_flo(out) if out.exists() else None
    check(rc == 0 and flow is not None,
          f"epicflow CLI: exit code {rc} ({wall:.1f} s)")
    if flow is None:
        return
    med = [float(np.median(flow[8:-8, 8:-8, c])) for c in (0, 1)]
    RECORD["epicflow_cli"] = dict(rc=rc, wall_s=wall, median_flow=med)
    check(all(abs(m - t) <= EPICFLOW_TOL for m, t in zip(med, BENCH_UV)),
          f"epicflow CLI: interior median flow ({med[0]:.4f}, {med[1]:.4f}) "
          f"vs {BENCH_UV}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible to torch "
              f"{torch.__version__}; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import slowflow_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    RECORD["nvidia_smi"] = smi[0]
    RECORD["torch"] = torch.__version__
    OUT_DIR.mkdir(exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    for fn in (build, kernels_vs_twins, route_kernels_vs_twins, slice_merged,
               slice_stack_composed, slice_unfused_pallas_warp,
               slice_profiles, cli_stage2, cli_stage2_epic, stage1,
               epicflow_cli):
        phase(fn)

    kv = RECORD.get("kernels_vs_twins", {})
    slices = RECORD.get("slices", {})
    bench_shape = [4, 270, 480]

    def kernel_entry(name, source, replaces, route, main_case):
        rows = kv.get(name, [])
        main = [r for r in rows if r["shape"] == bench_shape and main_case(r)]
        main = main[0] if main else {}
        counts = slices.get(route, {}).get("kernel_counts", {})
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": max((r["abs_err"] for r in rows), default=None),
                **{k: main.get(k) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms", "launches_per_call", "device_ms")}}

    csrc = "slowflow_tpu_torch/csrc/"
    line = {"kernels": [
        kernel_entry("warp_assemble", csrc + "warp_assemble.cu",
                     "slowflow_tpu/variational/fused_warp.py:369", "merged",
                     lambda r: r["mode"] == "assembly" and r["zero_duv"]),
        kernel_entry("solve_step", csrc + "solve_step.cu",
                     "slowflow_tpu/variational/fused_solve.py:375", "merged",
                     lambda r: r["method"] == 1 and r["zero_init"]),
        kernel_entry("fused_data", csrc + "fused_data.cu",
                     "slowflow_tpu/variational/fused_data.py:438", "stack",
                     lambda r: r["mode"] == "assembly" and r["zero_duv"]),
        kernel_entry("warp_stack", csrc + "warp_stack.cu",
                     "slowflow_tpu/core/warp_shift.py:120", "stack",
                     lambda r: r["motion"] == "bench"),
        kernel_entry("sor", csrc + "solve_step.cu",
                     "slowflow_tpu/core/solver_pallas.py:126", "stack",
                     lambda r: True),
        kernel_entry("warp_stack_pallas", csrc + "warp_stack.cu",
                     "slowflow_tpu/core/warp_pallas.py:138", "unfused",
                     lambda r: True),
    ]}
    # K5 on stage 1's path: launches of the stage-1 run, time at B = 40
    k5_b40 = [r for r in kv.get("sor", []) if r["shape"] == [40, 270, 480]]
    line["kernels"][4]["stage1_launches"] = RECORD.get("stage1", {}).get(
        "launches", {}).get("sor", 0)
    line["kernels"][4]["b40"] = {k: k5_b40[0].get(k) for k in (
        "ms", "plain_ms", "bound_ms", "device_ms")} if k5_b40 else None
    # K1 / K2 launches on the EPIC-initialized CLI run
    epic_run = RECORD.get("cli_stage2_epic", {}).get("deep_matching_1", {})
    for entry in line["kernels"][:2]:
        entry["cli_epic_launches"] = epic_run.get("launches", {}).get(
            entry["name"], 0)
    # K3's other modes at the bench shape
    line["kernels"][2]["modes"] = {
        f"{r['mode']} zero_duv={r['zero_duv']}": dict(
            ms=r["ms"], device_ms=r["device_ms"], bound_ms=r["bound_ms"])
        for r in kv.get("fused_data", []) if r["shape"] == bench_shape}
    for entry in line["kernels"]:
        check(entry["launches"] > 0 and entry["ms"] is not None
              and entry["bound_ms"] is not None,
              f"{entry['name']}: {entry['launches']} launches on its route, "
              f"{entry['ms']} ms, bound {entry['bound_ms']} ms")
    for name in ("solve_step", "sor"):
        per_call = {r.get("launches_per_call") for r in kv.get(name, [])}
        check(per_call == {1}, f"{name}: CUDA launches per call under the "
              f"profiler {sorted(per_call, key=str)} (one cooperative launch)")
    RECORD["failures"] = FAILURES
    with open(OUT_DIR / "chip_smoke.json", "w") as fh:
        json.dump(RECORD, fh, indent=1)
    if FAILURES:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILURES))
        return 1
    print(smi[0])
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
