"""Where the time of K1 and K2 goes: textual variants of their sources, built
and timed beside the real kernels on one card.

    python3 -m slowflow_tpu_torch.kernel_variants

Measurement script; the port never calls it. Each variant is the kernel's
sources in csrc/ with named substitutions (the script fails if one no
longer matches), built by nvcc into its own library under
_build/variants/. Device time per call comes from torch.profiler (mean of
10 calls after a warm-up). K1 variants run method 1 from zero with the
change sums at 0 and 30 sweeps, so (t30 - t0) / 60 is the cost of one
half-sweep and t0 the prologue, epilogue and launch:
  kernel        csrc/solve_step.cu as built
  grid_barrier  a grid-wide barrier before each half-sweep's halo fetch
                (in place of polling the neighbours' cells alone)
  threads_1024  1024 threads per resident block instead of 512
  no_exchange   no publish / fetch (results wrong: isolates the exchange)
  no_interior   boundary rows only (results wrong)
  no_compute    exchange only, no cell updates (results wrong)
K2 (`assembly`, zero_duv, 4 x 270 x 480):
  kernel        csrc/warp_assemble.cu as built
  load_only     the load phase (warp into shared memory) and one store
Prints one JSON line per measurement and writes kernel_variants.json to
chip_smoke.py's output directory.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import kernels

K1_FETCH = """      if (t > 0) {  // the neighbours' colour c ^ 1 of half-sweep t - 1
        fetch_halo(a, d, c ^ 1, (unsigned)t, tid, nt);"""
K1_BOUNDARY = """      half_sweep(d, W, a.hwp, c, a.omega, 0, edges, d.rows - 1, tid, nt);"""
K1_PUBLISH = """      publish(a, d, c, (unsigned)t + 1);"""
K1_INTERIOR = """      half_sweep(d, W, a.hwp, c, a.omega, 1, d.rows - 2, 1, tid, nt);"""
K2_ASSEMBLE = """  assemble_tile<MODE, ZERO_DUV>(P, frames, sx, sy, cw, du, dv, out, b, B, H,
                                W, x0, y0, mask_of);"""
K2_STORE = """  if (gx < W && gy < H)
    out[b * HW + (size_t)gy * W + gx] = frames[(threadIdx.y + EXT) * LW + threadIdx.x + EXT];"""

# source built -> variant -> file -> {old: new}
VARIANTS = {
    "solve_step.cu": {
        "grid_barrier": {"solve_step.cu": {K1_FETCH: K1_FETCH.replace(
            "fetch_halo(", "grid.sync();\n        fetch_halo(")}},
        "threads_1024": {"solve_step.cu": {
            "constexpr int NT_RESIDENT = 512,":
            "constexpr int NT_RESIDENT = 1024,"}},
        "no_exchange": {"solve_step.cu": {K1_FETCH: "      if (false) {",
                                          K1_PUBLISH: ""}},
        "no_interior": {"solve_step.cu": {K1_INTERIOR: ""}},
        "no_compute": {"solve_step.cu": {K1_BOUNDARY: "", K1_INTERIOR: ""}},
    },
    "warp_assemble.cu": {
        "load_only": {"warp_assemble.cu": {K2_ASSEMBLE: K2_STORE}},
    },
}
K1_SHAPES = ((4, 270, 480), (4, 176, 314), (4, 51, 90))


def build_variants() -> dict:
    """{(source, variant): ctypes library}; the real kernels under
    'kernel'."""
    nvcc = kernels._nvcc()
    root = kernels.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for src, variants in VARIANTS.items():
        for name, files in variants.items():
            d = root / f"{src[:-3]}_{name}"
            d.mkdir(parents=True)
            for f in [src, *kernels.CSRC.glob("*.cuh")]:
                shutil.copy(kernels.CSRC / f, d)
            for f, subs in files.items():
                body = (d / f).read_text()
                for old, new in subs.items():
                    if old not in body:
                        raise RuntimeError(f"{src} {name}: substitution in "
                                           f"{f} no longer matches:\n{old}")
                    body = body.replace(old, new)
                (d / f).write_text(body)
            so = d / "lib.so"
            jobs[(src, name)] = (so, subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
                 str(d / src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    libs = {("solve_step.cu", "kernel"): kernels.load(),
            ("warp_assemble.cu", "kernel"): kernels.load()}
    for key, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for fn in ("sf_solve_step", "sf_solve_plan", "sf_warp_assemble"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def device_ms(fn, reps: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3


def _k1(lib, b, h, w, iterations, dev):
    from .variational.params import MultiFrameParams

    rng = np.random.default_rng(0)
    planes = [rng.normal(0, 1, (b, h, w)), rng.normal(0, 1, (b, h, w)),
              0.5 * rng.random((b, h, w)), 1 + rng.random((b, h, w)),
              0.3 * rng.normal(0, 1, (b, h, w)), 1 + rng.random((b, h, w)),
              rng.normal(0, 1, (b, h, w)), rng.normal(0, 1, (b, h, w))]
    t = [torch.tensor(x, dtype=torch.float32, device=dev) for x in planes]
    ndu, ndv = torch.empty((2, b, h, w), device=dev)
    sums = torch.empty((b, 2), device=dev)
    plan = (ctypes.c_longlong * 8)()
    kernels.check(lib.sf_solve_plan(0, b, h, w, plan), "sf_solve_plan")
    scratch = torch.empty(plan[6], device=dev)
    fct, eps_sq, trunc, trunc_val = MultiFrameParams().penalties()[2] \
        .kernel_args()
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def call():
        kernels.check(lib.sf_solve_step(
            *(ptr(x) for x in (*t, None, None, ndu, ndv, scratch)), plan[6],
            ptr(sums), b, h, w, 1, int(fct), eps_sq, trunc, trunc_val, 4.0,
            iterations, 1.9, stream), "sf_solve_step")
    return device_ms(call)


def _k2(lib, dev):
    from .variational.fused_data import kernel_params
    from .variational.params import MultiFrameParams

    b, h, w = 4, 270, 480
    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0))
    rng = np.random.default_rng(0)
    seq = torch.tensor(rng.random((b, 5, 3, h, w)) * 255,
                       dtype=torch.float32, device=dev)
    wx, wy = (torch.tensor(np.clip(rng.normal(m, 1.5, (b, h, w)), -3, 3),
                           dtype=torch.float32, device=dev)
              for m in (1.0, -0.5))
    occ = torch.tensor(rng.integers(-1, 2, (b, h, w)), dtype=torch.float32,
                       device=dev)
    cw = torch.ones((b, 3, h, w), device=dev)
    out = torch.empty((5, b, h, w), device=dev)
    params = kernel_params(p)
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def call():
        kernels.check(lib.sf_warp_assemble(
            ptr(seq), ptr(wx), ptr(wy), ptr(occ), None, None, ptr(cw),
            ptr(out), b, h, w, 0, 1, ctypes.c_void_p(params.ctypes.data),
            params.size, stream), "sf_warp_assemble")
    return device_ms(call)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_variants()
    rows = []
    for (src, name), lib in sorted(libs.items()):
        if src == "solve_step.cu":
            for shape in K1_SHAPES:
                t0, t30 = (_k1(lib, *shape, it, dev) for it in (0, 30))
                rows.append(dict(kernel="K1", variant=name, shape=shape,
                                 ms_0_sweeps=t0, ms_30_sweeps=t30,
                                 us_per_half_sweep=(t30 - t0) / 60 * 1e3))
        else:
            rows.append(dict(kernel="K2 assembly zero_duv", variant=name,
                             shape=(4, 270, 480), ms=_k2(lib, dev)))
        print(json.dumps(rows[-3 if src == "solve_step.cu" else -1:]),
              flush=True)
    from .ab_smoke import _out_dir

    out = _out_dir()
    out.mkdir(exist_ok=True)
    (out / "kernel_variants.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
