"""The whole pipeline through the port's CLIs: stage 1 (`adaptive_fr`), stage
2 (`slow_flow`), stage 3 (`dense_tracking`) on a teaser-shaped synthetic
sequence (the port of the JAX package's `tools/bench_pipeline.py`).

    python -m slowflow_tpu_torch.bench_pipeline [--jets N] [--finals N]
        [--batch B] [--threads N] [--out DIR] [--save PATH]
        [--device cuda|cpu (default: cuda)]

The scene is the bench scene's two layers (a smooth background translating
(1.5, -0.8) px/frame and a disc of foreground moving against it in x, so the
occlusion reasoning has real boundaries), written as 8-bit PNGs at the
480x270 working resolution of the teaser (1080p at scale 0.25). Production
shape: 200 fps to 20 fps with S = 3 (steps 2), so 5 jets per final pair;
`--jets 225 --finals 8 --threads 2` is the teaser's jet count. Stage 2 runs
the production cfg (5 levels, 10 x 10 x 30 iterations, occlusion reasoning,
EPIC init) with `-batch`; stage 3 alternates 5 times with 20 tryouts.

Accuracy, as the JAX tool scores it: `quantil` is stage 1's quantile (the
motion is |(1.5, -0.8)| = 1.70 px/frame); `sf_flow_err_px` is the median
|flow - 2 (1.5, -0.8)| of the first jet's forward `.flo` over its interior
(12 px crop) outside the disc's corridor (`bg_mask`); `dt_flow_err_px` the
same for the first final's flow, which is on the grid subsampled by 2, so its
truth is 5 * 2 * (1.5, -0.8) / 2 (6 px crop).

Prints per-stage walls, peak device memory and the stage-2 CLI's phase split
(`sf.init_wait`, `sf.solve`, `sf.batch` per batch), then one JSON line with
the JAX tool's keys (unrounded) and those. The run's tree goes to `--out`
(wiped first), by default a temporary directory that is removed afterwards.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import torch

from .io import read_flo, write_image
from .runtime import resolve_device
from .utils import phases
from .utils.tracing import StageTimer

U, V = 1.5, -0.8        # background motion, px/frame
H, W = 270, 480         # the working resolution
START = 2               # = ref * skip: the first window reaches back ref frames
STEPS = 2               # S = 3
DT_JETS = 200 // (20 * STEPS)   # jets per final pair
XY_INCR = 2             # acc_skip_pixel 1: stage 3 tracks every 2nd pixel


def make_sequence(seq_dir: Path, n_frames: int, seed: int = 0, *, h: int = H,
                  w: int = W) -> None:
    """The two-layer scene as `frame_%04d.png` 8-bit RGB frames in
    `seq_dir`: the background translating (U, V) px/frame, a disc of
    another texture moving (-U, V) px/frame over it."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(n_frames * max(abs(U), abs(V)))) + 4
    shape = (h + 2 * pad, w + 2 * pad)
    base = rng.random(shape).astype(np.float32) * 255
    fg = rng.random(shape).astype(np.float32) * 255
    for _ in range(2):
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                       + np.roll(base, 1, 1) + np.roll(base, -1, 1))
        fg = 0.25 * (np.roll(fg, 1, 0) + np.roll(fg, -1, 0)
                     + np.roll(fg, 1, 1) + np.roll(fg, -1, 1))
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx, r = h // 2, w // 2, min(h, w) // 6

    def sample(img, dx_t, dy_t):
        xs = np.clip(xx + pad - dx_t, 0, shape[1] - 2)
        ys = np.clip(yy + pad - dy_t, 0, shape[0] - 2)
        x0 = xs.astype(int)
        y0 = ys.astype(int)
        fx = xs - x0
        fy = ys - y0
        return (img[y0, x0] * (1 - fx) * (1 - fy)
                + img[y0, x0 + 1] * fx * (1 - fy)
                + img[y0 + 1, x0] * (1 - fx) * fy
                + img[y0 + 1, x0 + 1] * fx * fy)

    seq_dir.mkdir(parents=True, exist_ok=True)
    for f in range(n_frames):
        im = sample(base, f * U, f * V)
        im_fg = sample(fg, -f * U, f * V)
        in_fg = ((yy - (cy + f * V)) ** 2 + (xx - (cx - f * U)) ** 2) < r * r
        im = np.where(in_fg, im_fg, im)
        write_image(seq_dir / f"frame_{f:04d}.png",
                    np.repeat(im[..., None], 3, -1))


def bg_mask(f_lo: int, f_hi: int, h: int = H, w: int = W) -> np.ndarray:
    """True on the background over frames [f_lo, f_hi]: every pixel outside
    the disc's corridor (6 px beyond its radius), whose true flow is the
    disc's counter-motion and not the background's."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    m = np.ones((h, w), bool)
    for f in range(f_lo, f_hi + 1):
        m &= ((yy - (cy + f * V)) ** 2
              + (xx - (cx - f * U)) ** 2) >= (r + 6) ** 2
    return m


def sf_flow_err(flow: np.ndarray, h: int = H, w: int = W) -> float:
    """`sf_flow_err_px` of the first jet's forward flow [h, w, 2]."""
    inner = (slice(12, -12), slice(12, -12))
    err = np.hypot(flow[inner][..., 0] - STEPS * U,
                   flow[inner][..., 1] - STEPS * V)
    return float(np.median(err[bg_mask(START, START + STEPS, h, w)[inner]]))


def dt_flow_err(flow: np.ndarray, h: int = H, w: int = W,
                start: int = START) -> float:
    """`dt_flow_err_px` of the final flow [h / 2, w / 2, 2] that starts at
    frame `start` (the first final by default), in units of the subsampled
    grid (the reference divides by xy_incr, dense_tracking.cpp:1856-1857)."""
    inner = (slice(6, -6), slice(6, -6))
    err = np.hypot(flow[inner][..., 0] - DT_JETS * STEPS * U / XY_INCR,
                   flow[inner][..., 1] - DT_JETS * STEPS * V / XY_INCR)
    mask = bg_mask(start, start + DT_JETS * STEPS, h, w)[::XY_INCR, ::XY_INCR]
    return float(np.median(err[mask[inner]]))


def stage2_cfg(root: Path, jets: int, *, levels: int = 5,
               niter_alter: int = 10, niter_outer: int = 10,
               niter_solver: int = 30) -> str:
    """The production stage-2 cfg (cfgs/slow_flow.cfg's values; adaptive
    frame rates off so that 200 -> 20 fps at steps 2 gives 5 jets per
    final pair)."""
    return textwrap.dedent(f"""\
    file\t{root}/seq/frame_%04i.png
    output\t{root}/sf_out
    Jets\t{jets}
    start\t{START}
    max_fps\t200
    ref_fps\t20
    jet_fps\t200
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t1
    slow_flow_method\tsymmetric
    slow_flow_S\t{STEPS + 1}
    slow_flow_rho_0\t1
    slow_flow_rho_1\t1
    slow_flow_omega_0\t0
    slow_flow_omega_1\t2
    slow_flow_dataterm\t1
    slow_flow_smoothing\t1
    slow_flow_delta\t1.0
    slow_flow_gamma\t6.0
    slow_flow_alpha\t4.0
    slow_flow_layers\t{levels}
    slow_flow_p_scale\t0.9
    slow_flow_occlusion_reasoning\t1
    slow_flow_niter_alter\t{niter_alter}
    slow_flow_niter_outer\t{niter_outer}
    slow_flow_niter_inner\t1
    slow_flow_niter_solver\t{niter_solver}
    """)


def stage3_cfg(root: Path, finals: int) -> str:
    """The stage-3 cfg: every 2nd pixel, EPIC hypotheses, 5 alternations,
    20 tryouts, seed 3."""
    return textwrap.dedent(f"""\
    file\t{root}/seq/frame_%04i.png
    jet_estimation\t{root}/sf_out/
    flow_format\tframe_%04i
    output\t{root}/dt_out
    start\t{START}
    max_fps\t200
    ref_fps\t20
    ref_fps_F\t{finals}
    16bit\t0
    raw\t0
    scale\t1.0
    acc_skip_pixel\t{XY_INCR - 1}
    acc_occlusion\t0
    acc_epic_interpolation\t1
    acc_epic_skip\t2
    acc_alternate\t5
    acc_trws_max_iter\t10
    acc_neigh_hyp\t5
    acc_hyp_neigh_tryouts\t20
    acc_consistency_threshold\t1.0
    acc_brightness_constancy\t0.1
    acc_gradient_constancy\t1.0
    seed\t3
    """)


def run_pipeline(root: Path, jets: int, finals: int, samples: int = 4,
                 batch: int = 4, threads: int = 1, *, device=None,
                 h: int = H, w: int = W, levels: int = 5,
                 niter_alter: int = 10, niter_outer: int = 10,
                 niter_solver: int = 30) -> dict:
    """Generate the sequence under `root` (wiped first) and run the three
    CLIs on it with `-device`. `device`: None means CUDA (which raises when
    torch finds no GPU). h, w and the stage-2 depth (levels, iterations)
    are cut only by the tests. Returns the metrics dict."""
    from . import kernels, native
    from .cli import adaptive_fr, dense_tracking, slow_flow

    device = resolve_device(device)
    dev_arg = ["-device", str(device)]
    cuda = device.type == "cuda"
    root = Path(root)
    if root.exists():
        shutil.rmtree(root)
    n_frames = START + 1 + (jets + 2) * STEPS
    timer = StageTimer()
    peak = {}

    def stage(name, argv, fn):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        with timer.stage(name):
            rc = fn(argv)
            if cuda:
                torch.cuda.synchronize(device)
        if rc != 0:
            raise RuntimeError(f"{name}: exit code {rc} ({argv})")
        peak[name] = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
            if cuda else None

    with timer.stage("build"):
        # the one-time builds (g++, nvcc; kept by source hash) and the CUDA
        # context stay out of the stages' walls
        native.load()
        if cuda:
            kernels.load()
            torch.zeros(1, device=device)
    with timer.stage("seq_gen"):
        make_sequence(root / "seq", n_frames, h=h, w=w)

    stage("stage1_adaptive_fr",
          ["-path", str(root), "-folder", "seq", "-format", "frame_%04i.png",
           "-scale", "0.5", "-skip", "2", "-samples", str(samples), "-step",
           "2", "-start", "0", *dev_arg], adaptive_fr.main)
    quantil = float((root / "seq" / "quantil.dat").read_text().split()[0])

    cfg2 = root / "slow_flow.cfg"
    cfg2.write_text(stage2_cfg(root, jets, levels=levels,
                               niter_alter=niter_alter,
                               niter_outer=niter_outer,
                               niter_solver=niter_solver))
    with phases.recording() as sf_phases:
        stage("stage2_slow_flow", [str(cfg2), "-batch", str(batch), *dev_arg],
              slow_flow.main)
    sf_err = sf_flow_err(read_flo(root / "sf_out" / f"frame_{START:04d}.flo"),
                         h, w)

    cfg3 = root / "dense_tracking.cfg"
    cfg3.write_text(stage3_cfg(root, finals))
    dt_argv = [str(cfg3), *dev_arg]
    if threads > 1:
        dt_argv += ["-threads", str(threads)]
    stage("stage3_dense_tracking", dt_argv, dense_tracking.main)
    dt_err = dt_flow_err(read_flo(root / "dt_out" / f"frame_{START:04d}.flo"),
                         h, w)

    t = timer.totals
    t1, t2, t3 = (t["stage1_adaptive_fr"], t["stage2_slow_flow"],
                  t["stage3_dense_tracking"])
    solves = 2 * jets                       # forward + backward per jet
    return {
        "pipeline_s": t1 + t2 + t3,
        # every cost of the pipeline charged to its jets: stage-1 sampling,
        # the EPIC init, I/O, the solves and dense tracking
        "pipeline_jets_per_sec": jets / (t1 + t2 + t3),
        "stage1_adaptive_fr_s": t1,
        "stage2_slow_flow_s": t2,
        "stage2_solves": solves,
        "stage2_solves_per_sec": solves / t2,
        "stage3_dense_tracking_s": t3,
        "stage3_finals": finals,
        "stage3_threads": threads,
        "stage3_s_per_final": t3 / finals,
        "jets": jets,
        "quantil": quantil,
        "sf_flow_err_px": sf_err,
        "dt_flow_err_px": dt_err,
        "seq_gen_s": t["seq_gen"],
        "build_s": t["build"],
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "shape": [h, w],
        "peak_memory_gib": peak,
        # the stage-2 CLI's phases: {name: [seconds, count]}; sf.batch,
        # sf.solve and sf.init_wait are timed once per batch
        "stage2_phases": {k: list(v) for k, v in sorted(sf_phases.items())},
        "stage2_per_batch_s": {
            k: sf_phases[k][0] / sf_phases[k][1]
            for k in ("sf.batch", "sf.solve", "sf.init_wait")
            if k in sf_phases},
        "stage_summary": timer.summary(),
    }


def print_report(out: dict) -> None:
    """The per-stage walls, peak memory and stage-2 phase split, one line
    each."""
    print(out["stage_summary"])
    for name, gib in out["peak_memory_gib"].items():
        print(f"{name} peak device memory: "
              + ("not measured (CPU)" if gib is None else f"{gib:.3f} GiB"))
    for name, s in out["stage2_per_batch_s"].items():
        print(f"stage 2 {name}: {s:.4f} s per batch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jets", type=int, default=10)
    ap.add_argument("--finals", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--threads", type=int, default=1,
                    help="stage-3 final-pair prefetch threads")
    ap.add_argument("--out", default=None,
                    help="the run's tree (wiped first); default: a temporary "
                         "directory, removed afterwards")
    ap.add_argument("--save", default="", help="also write the JSON here")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(args.out) if args.out else Path(tmp) / "pipeline"
        out = run_pipeline(root, args.jets, args.finals, batch=args.batch,
                           threads=args.threads, device=args.device)
    print_report(out)
    print(json.dumps(out))
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        Path(args.save).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
