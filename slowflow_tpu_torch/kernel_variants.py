"""Where the time of K1-K4 and the grid matcher goes: textual variants of
their sources, built and timed beside the real kernels on one card.

    python3 -m slowflow_tpu_torch.kernel_variants [--only SOURCE ...]

Measurement script; the port never calls it. Each variant is the kernel's
sources in csrc/ with named substitutions (the script fails if one no
longer matches), built by nvcc into its own library under
_build/variants/. Device time per call comes from torch.profiler (mean of
10 calls after a warm-up). K1 variants run method 1 from zero with the
change sums at 0 and 30 sweeps, so (t30 - t0) / 60 is the cost of one
half-sweep and t0 the prologue, epilogue and launch, on the resident,
grouped and row-streamed paths (K1_SHAPES):
  kernel           csrc/solve_step.cu as built
  grid_barrier     a grid-wide barrier before each half-sweep's halo fetch
                   (in place of polling the neighbours' cells alone)
  threads_1024     1024 threads per block instead of 512
  group_below_max  grouped: groups of at most G_max - 1 jets
  ring_no_copy     row-streamed: no copy into the ring (results wrong:
                   isolates the stream from HBM)
  ring_no_update   row-streamed: the ring's rows land, no cell is updated
                   (results wrong: isolates the updates)
  no_evict_first   row-streamed: no L2 hint that evicts the copied
                   coefficients before du / dv
  keep_weights     row-streamed: wh and wv kept in L2 like du / dv
  ahead2           row-streamed: rings 2 rows ahead (3 own, 4 nbr rows)
                   for 3 (4 own, 5 nbr)
  chunk480         row-streamed: ring rows of at most 480 packed cells
                   (1080p rows in 2 chunks) for 960
  no_exchange      no publish / fetch (results wrong: isolates the exchange)
  no_interior      on chip: boundary rows only (results wrong)
  no_compute       on chip: exchange only, no cell updates (results wrong)
K2 (`assembly`, zero_duv, 4 x 270 x 480):
  kernel        csrc/warp_assemble.cu as built
  load_only     the load phase (warp into shared memory) and one store
K3 (`assembly` zero_duv, `occ`, `occ_assembly`; 4 x 270 x 480, S = 3):
  kernel        csrc/fused_data.cu as built
  load_only     the frames' cp.async stream and the stores, no derivative
                tiles and no assembly (results wrong)
  no_derivs     no Ix / Iy tile pass per offset; the assembly reads stale
                shared memory (results wrong: isolates the tile pass)
K4 (4 x 5 x 3 x 270 x 480, bench-like flow: frame ref copied, with and
without the masks) and K6's entry (every frame warped), beside grid_sample
on K6's planes:
  kernel            csrc/warp_stack.cu as built (1 pixel a thread, 8 x 32
                    tiles, three channels unrolled)
  pix2, pix4_ty4    2 pixels a thread (8 x 64 tiles); 4 (4 x 128 tiles)
  runtime_channels  the channel count as a runtime loop bound (K6's
                    warp_bilinear entry with C != 3)
The grid matcher (both directions at chip_smoke's phase 5 shape, 4 x 270
x 480 radius 50, and stage 1's, 40 x 270 x 480 radius 32, on its scenes;
`labels_equal`: the forward labels equal the built kernel's):
  kernel        csrc/grid_match.cu as built (NX = 8 displacements a thread,
                256 threads a block, float4 reads, window by cp.async)
  nx4, nx1      4 and 1 displacements a thread (nx1: scalar reads)
  nt128         128 threads a block
  general       every block on the general tap loop (the bound tests per
                tap, as for a patch with a negative value)
  clipped_all   every block on the tap loop with the block-uniform cut at
                the last patch column (the path of points near the left or
                right edge)
  runtime_taps  the runtime-p instance at p = 4 (taps in a runtime loop,
                scalar reads, odd pitch)
  scalar_loads  window and patch rows read one float at a time
  sync_staging  the window staged by plain loads and stores, not cp.async
  stage_only    the patch and window staging and the reduction, no
                displacement scanned (labels wrong: isolates the staging)
`--only grid_match.cu` builds and times one source's variants alone.
Prints one JSON line per measurement and writes kernel_variants.json to
chip_smoke.py's output directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import kernels

K1_FETCH = """        if (t > 0) {  // the neighbours' colour c ^ 1 of half-sweep t - 1
          fetch_halo(a, d, c ^ 1, (unsigned)t, tid, NT);"""
K1_BOUNDARY = """        half_sweep(d, W, a.hwp, c, a.omega, 0, edges, d.rows - 1, tid, NT);"""
K1_PUBLISH = """        publish(a, d, c, (unsigned)t + 1);"""
K1_INTERIOR = """        half_sweep(d, W, a.hwp, c, a.omega, 1, d.rows - 2, 1, tid, NT);"""
K1_GROUPS = "p.groups = (B + gmax - 1) / gmax;"
K1_RING_EXPECT = ("bar_expect(bar(q), 4u * (nw * (hi - lo) + (nwv + no) * "
                  "kc));")
K1_RING_COPIES = """    for (int w = 0; w < nw; ++w)
      bulk_copy(s + w * (a.kc + 8) + lo - (k0 - 4),
                (w == 0 ? d.du : w == 1 ? d.dv : d.wh) + r + lo,
                4u * (hi - lo), bar(q), w == 2);
    if (nwv) bulk_copy(s + L.nwv, d.wv + r + k0, 4u * kc, bar(q), true);
    for (int w = 0; w < no; ++w)
      bulk_copy(own_row(q) + w * a.kc, own[w] + o + k0, 4u * kc, bar(q),
                w > 1);
"""
K1_EVICT = "  if (first)\n    asm volatile(\"createpolicy.fractional.L2::evict_first"
K2_ASSEMBLE = """  assemble_tile<MODE, ZERO_DUV>(P, frames, sx, sy, cw, du, dv, out, b, B, H,
                                W, x0, y0, mask_of);"""
K2_STORE = """  if (gx < W && gy < H)
    out[b * HW + (size_t)gy * W + gx] = frames[(threadIdx.y + EXT) * LW + threadIdx.x + EXT];"""
K3_BUILD = """            build_pair(pairs + pair * PAIR_FLOATS, slot(frame_a(s, pair)),
                       slot(frame_b(s, pair)), tid);"""
K3_OFFSET = """      offset(s);\n"""
K4_CHANNELS = "return (int)(C == 3 ? launch<3>("
K7_PATH = "const bool general = __syncthreads_or(neg);"
K7_SCAN = """    if (general)
      scan_band<Q, GENERAL>(s, dy0, dy1, r, best, best_k);
    else if (Q > 0 && s.nq == Q)
      scan_band<Q, UNROLLED>(s, dy0, dy1, r, best, best_k);
    else if (Q > 0)
      scan_band<Q, CLIPPED>(s, dy0, dy1, r, best, best_k);
    else
      scan_band<Q, RUNTIME>(s, dy0, dy1, r, best, best_k);"""
K7_NX = "constexpr int NX = 8;"
K7_VEC = "constexpr bool VEC = NX % 4 == 0;"
K7_STAGE = """        if (gx >= 0 && gx < W)
          sf::cp_async4(dst + c, src + gx);
        else
          dst[c] = SENTINEL;"""
K7_INSTANCE = ("2 * p + 1 == CLI_Q ? grid_match_kernel<CLI_Q> : "
               "grid_match_kernel<0>")

# source built -> variant -> file -> {old: new}
VARIANTS = {
    "solve_step.cu": {
        "grid_barrier": {"solve_step.cu": {K1_FETCH: K1_FETCH.replace(
            "fetch_halo(", "grid.sync();\n          fetch_halo(")}},
        "threads_1024": {"solve_step.cu": {
            "constexpr int NT = 512;": "constexpr int NT = 1024;"}},
        "group_below_max": {"solve_step.cu": {K1_GROUPS: K1_GROUPS.replace(
            "gmax", "std::max(1, gmax - 1)")}},
        "ring_no_copy": {"solve_step.cu": {
            K1_RING_EXPECT: 'asm volatile("mbarrier.arrive.shared::cta.b64 '
                            '_, [%0];" ::"r"(smem_addr(bar(q))) : "memory");',
            K1_RING_COPIES: "    (void)s;\n    (void)own;\n"}},
        "ring_no_update": {"solve_step.cu": {"      if (j < W) {":
                                             "      if (false) {"}},
        "no_evict_first": {"solve_step.cu": {K1_EVICT: K1_EVICT.replace(
            "(first)", "(false)")}},
        "keep_weights": {"solve_step.cu": {
            "4u * (hi - lo), bar(q), w == 2);": "4u * (hi - lo), bar(q), false);",
            "d.wv + r + k0, 4u * kc, bar(q), true);":
            "d.wv + r + k0, 4u * kc, bar(q), false);",
            "bar(q),\n                w > 1);": "bar(q),\n                w > 3);"}},
        "ahead2": {"solve_step.cu": {"constexpr int AHEAD = 3;":
                                     "constexpr int AHEAD = 2;"}},
        "chunk480": {"solve_step.cu": {"constexpr int CHUNK = 960;":
                                       "constexpr int CHUNK = 480;"}},
        "no_exchange": {"solve_step.cu": {K1_FETCH: "      if (false) {",
                                          K1_PUBLISH: ""}},
        "no_interior": {"solve_step.cu": {K1_INTERIOR: ""}},
        "no_compute": {"solve_step.cu": {K1_BOUNDARY: "", K1_INTERIOR: ""}},
    },
    "warp_assemble.cu": {
        "load_only": {"warp_assemble.cu": {K2_ASSEMBLE: K2_STORE}},
    },
    "fused_data.cu": {
        "load_only": {"fused_data.cu": {K3_BUILD: ";", K3_OFFSET: ""}},
        "no_derivs": {"fused_data.cu": {K3_BUILD: ";"}},
    },
    "warp_stack.cu": {
        "pix2": {"warp_stack.cu": {"constexpr int PIX = 1;":
                                   "constexpr int PIX = 2;"}},
        "pix4_ty4": {"warp_stack.cu": {
            "constexpr int PIX = 1;": "constexpr int PIX = 4;",
            "TX = 32, TY = 8,": "TX = 32, TY = 4,"}},
        "runtime_channels": {"warp_stack.cu": {
            K4_CHANNELS: K4_CHANNELS.replace("C == 3", "false")}},
    },
    "grid_match.cu": {
        "nx4": {"grid_match.cu": {K7_NX: K7_NX.replace("8", "4")}},
        "nx1": {"grid_match.cu": {K7_NX: K7_NX.replace("8", "1")}},
        "nt128": {"grid_match.cu": {"constexpr int NT = 256;":
                                    "constexpr int NT = 128;"}},
        "general": {"grid_match.cu": {K7_PATH: K7_PATH.replace(
            "(neg)", "(neg) | true")}},
        "clipped_all": {"grid_match.cu": {
            "else if (Q > 0 && s.nq == Q)": "else if (false)"}},
        "runtime_taps": {"grid_match.cu": {
            K7_INSTANCE: "grid_match_kernel<0>",
            "if (q == CLI_Q) {": "if (false) {"}},
        "scalar_loads": {"grid_match.cu": {K7_VEC: K7_VEC.replace(
            "NX % 4 == 0", "false")}},
        "sync_staging": {"grid_match.cu": {
            K7_STAGE: "        dst[c] = gx >= 0 && gx < W ? src[gx] "
                      ": SENTINEL;",
            "    sf::cp_async_wait_all();\n": ""}},
        "stage_only": {"grid_match.cu": {K7_SCAN: "    (void)general;"}},
    },
}
K7_SHAPES = (("stage2", 4, 50), ("stage1", 40, 32))   # chip_smoke's scenes
K3_MODES = (("assembly", True), ("occ", True), ("occ_assembly", True))
# resident (the bench shape, its coarsest level, a small one), grouped (2
# and 8 groups), row-streamed (1080p, 2160p)
K1_SHAPES = ((4, 270, 480), (4, 176, 314), (4, 51, 90), (8, 270, 480),
             (40, 270, 480), (1, 1080, 1920), (1, 2160, 3840))


def build_variants(only=None) -> dict:
    """{(source, variant): ctypes library}; the real kernels under
    'kernel'. `only`: the sources to build variants of (default all)."""
    nvcc = kernels._nvcc()
    root = kernels.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    chosen = {src: v for src, v in VARIANTS.items()
              if only is None or src in only}
    for src, variants in chosen.items():
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
    libs = {(src, "kernel"): kernels.load() for src in chosen}
    for key, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for fn in ("sf_solve_step", "sf_solve_plan", "sf_warp_assemble",
                   "sf_fused_data", "sf_warp_stack", "sf_grid_match"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def device_ms(fn, reps: int = 10, attempts: int = 5,
              launches: int = 1) -> float:
    """Mean device time of `fn` over `reps` calls of `launches` kernels
    each. A profiler capture now and then holds no kernel record, or not
    all of them (chip_smoke._one_call_profile), so a capture without
    `reps * launches` records is taken again, at most `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(evs) >= reps * launches:
            return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3
    raise RuntimeError(f"the profiler saw {len(evs)} kernels for {reps} "
                       f"calls of {launches} in each of {attempts} captures")


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
    plan = (ctypes.c_longlong * 12)()
    kernels.check(lib.sf_solve_plan(b, h, w, plan), "sf_solve_plan")
    scratch = torch.empty(plan[6], device=dev)
    fct, eps_sq, trunc, trunc_val = MultiFrameParams().penalties()[2] \
        .kernel_args()
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def call():
        kernels.check(lib.sf_solve_step(
            *(ptr(x) for x in (*t, None, None, ndu, ndv, scratch)), plan[6],
            ptr(sums), None, b, h, w, 1, int(fct), eps_sq, trunc, trunc_val,
            4.0,
            iterations, 1.9, stream), "sf_solve_step")
    return device_ms(call)


def _window(dev):
    """The bench-shape window (4 x 5 x 3 x 270 x 480) and a bench-like
    flow, from a seed."""
    b, h, w = 4, 270, 480
    rng = np.random.default_rng(0)
    seq = torch.tensor(rng.random((b, 5, 3, h, w)) * 255,
                       dtype=torch.float32, device=dev)
    wx, wy = (torch.tensor(np.clip(rng.normal(m, 1.5, (b, h, w)), -3, 3),
                           dtype=torch.float32, device=dev)
              for m in (1.0, -0.5))
    occ = torch.tensor(rng.integers(-1, 2, (b, h, w)), dtype=torch.float32,
                       device=dev)
    return seq, wx, wy, occ


def _bench_params():
    from .variational.params import MultiFrameParams

    return MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0))


def _k2(lib, dev):
    from .variational.fused_data import kernel_params

    seq, wx, wy, occ = _window(dev)
    b, _, _, h, w = seq.shape
    cw = torch.ones((b, 3, h, w), device=dev)
    out = torch.empty((5, b, h, w), device=dev)
    params = kernel_params(_bench_params())
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def call():
        kernels.check(lib.sf_warp_assemble(
            ptr(seq), ptr(wx), ptr(wy), ptr(occ), None, None, ptr(cw),
            ptr(out), None, h, b, h, w, 0, 1,
            ctypes.c_void_p(params.ctypes.data),
            params.size, stream), "sf_warp_assemble")
    return device_ms(call)


def _k3(lib, dev, mode):
    """K3 on K4's stack of the bench window; `mode` with zero_duv."""
    from .core.warp_shift import warp_stack
    from .variational import terms
    from .variational.fused_data import MODES, kernel_params

    p = _bench_params()
    seq, wx, wy, occ = _window(dev)
    b, _, _, h, w = seq.shape
    warped, masks = warp_stack(seq, wx, wy, p.ref)
    mask = terms.succ_mask(masks, p.ref)
    if mode == "assembly":
        mask = terms.gate_masks(mask, occ, p)
    mask = mask.contiguous()
    cw = torch.ones((b, 3, h, w), device=dev)
    mode_id, n_out = MODES[mode]
    out = torch.empty((n_out, b, h, w), device=dev)
    params = kernel_params(p)
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def call():
        kernels.check(lib.sf_fused_data(
            ptr(warped), ptr(mask), None, None, ptr(cw), ptr(out), b, h, w,
            mode_id, 1, ctypes.c_void_p(params.ctypes.data), params.size,
            stream), "sf_fused_data")
    return device_ms(call)


def _k4(lib, dev, with_mask, identity):
    """K4 (identity = ref) or K6's entry (identity = -1, every frame
    warped) on the bench window, factors k - ref."""
    seq, wx, wy, _ = _window(dev)
    b, f, c, h, w = seq.shape
    out = torch.empty_like(seq)
    masks = torch.empty((b, f, h, w), device=dev) if with_mask else None
    fac = np.arange(f, dtype=np.float32) - f // 2
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def call():
        kernels.check(lib.sf_warp_stack(
            ptr(seq), ptr(wx), ptr(wy), ptr(out), ptr(masks), b, f, c, h, w,
            ctypes.c_void_p(fac.ctypes.data), identity, None, h, stream),
            "sf_warp_stack")
    return device_ms(call)


def _k7(lib, dev, scene, b, radius) -> dict:
    """Both directions of the grid matcher through `lib` on chip_smoke's
    `scene` pairs (b x 270 x 480, patch radius 4, the grid of step 8), the
    backward points from the built kernel's forward labels."""
    from chip_smoke import _match_pairs

    from .core.image import luminance
    from .epic import matching

    h, w, p, d = 270, 480, 4, 2 * radius + 1
    pairs = _match_pairs(scene, b, h, w, dev)
    g1, g2 = (luminance(pairs[:, i].contiguous()) for i in (0, 1))
    gy, gx = np.mgrid[4:h:8, 4:w:8]
    ys, xs = (torch.as_tensor(a.ravel(), device=dev).expand(b, -1)
              .contiguous() for a in (gy, gx))
    k = matching.grid_match(g1, g2, ys, xs, radius, p)
    y2 = (ys + k // d - radius).clamp(0, h - 1)
    x2 = (xs + k % d - radius).clamp(0, w - 1)
    out = torch.empty_like(ys)
    ptr, stream = kernels.ptr, kernels.stream_ptr(dev)

    def direction(a, c, y, x):
        kernels.check(lib.sf_grid_match(
            ptr(a), ptr(c), ptr(y), ptr(x), ptr(out), b, h, w, ys.shape[1],
            radius, p, stream), "sf_grid_match")

    direction(g1, g2, ys, xs)
    labels_equal = bool(torch.equal(out, k))

    def call():
        direction(g1, g2, ys, xs)
        direction(g2, g1, y2, x2)
    return dict(ms=device_ms(call, launches=2), labels_equal=labels_equal)


def _grid_sample(dev) -> float:
    """grid_sample's device time on the bench window, every frame warped
    (chip_smoke's yardstick)."""
    from chip_smoke import _grid_sample as yardstick

    seq, wx, wy, _ = _window(dev)
    f = seq.shape[1]
    return yardstick(seq, wx, wy,
                     [float(k - f // 2) for k in range(f)])["library_device_ms"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS),
                    help="time these sources' variants alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_variants(args.only)
    rows = []
    bench = (4, 270, 480)
    for (src, name), lib in sorted(libs.items()):
        new = []
        if src == "solve_step.cu":
            for shape in K1_SHAPES:
                t0, t30 = (_k1(lib, *shape, it, dev) for it in (0, 30))
                new.append(dict(kernel="K1", variant=name, shape=shape,
                                ms_0_sweeps=t0, ms_30_sweeps=t30,
                                us_per_half_sweep=(t30 - t0) / 60 * 1e3))
        elif src == "warp_assemble.cu":
            new.append(dict(kernel="K2 assembly zero_duv", variant=name,
                            shape=bench, ms=_k2(lib, dev)))
        elif src == "grid_match.cu":
            new += [dict(kernel=f"K7 grid_match {scene} both directions",
                         variant=name, shape=(b, 270, 480), radius=radius,
                         **_k7(lib, dev, scene, b, radius))
                    for scene, b, radius in K7_SHAPES]
        elif src == "fused_data.cu":
            new += [dict(kernel=f"K3 {mode} zero_duv={zero_duv}",
                         variant=name, shape=bench, ms=_k3(lib, dev, mode))
                    for mode, zero_duv in K3_MODES]
        else:
            window = (4, 5, 3, 270, 480)
            new += [dict(kernel=kernel, variant=name, shape=window,
                         ms=_k4(lib, dev, with_mask, identity))
                    for kernel, with_mask, identity in (
                        ("K4", True, 2), ("K4 no_mask", False, 2),
                        ("K6 factors -2..2", True, -1))]
            if name == "kernel":
                new.append(dict(kernel="grid_sample (K6's planes)",
                                variant="library", shape=window,
                                ms=_grid_sample(dev)))
        rows += new
        print(json.dumps(new), flush=True)
    from .ab_smoke import _out_dir

    out = _out_dir()
    out.mkdir(exist_ok=True)
    (out / "kernel_variants.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
