"""Stage 3's accuracy over its random seed on a pipeline tree: the stage-3
CLI again on the stage-2 output of a `bench_pipeline` run, once per seed,
each final scored as `dt_flow_err_px` scores the first.

    python -m slowflow_tpu_torch.bench_pipeline --jets 225 --finals 8 \\
        --threads 2 --out ROOT
    python3 -m slowflow_tpu_torch.stage3_seeds ROOT [--finals 8]
        [--seeds 3,1,2,4,5] [--threads 2] [--out PATH] [--device cuda|cpu]
        [--save-first-final DEST] [--cmd "python -m PACKAGE.cli.dense_tracking"]

Propagation draws its proposals from the cfg's `seed` (3 in the pipeline),
so one run's error is one sample. Prints the card, then per seed the wall
and the error of every final (final k starts at frame 2 + 10 k; the
background outside the disc's corridor over its frames), and writes the
record as JSON to PATH when given. The tree's stage-3 outputs go to
`ROOT/dt_seed<seed>`.

`--save-first-final DEST` first copies what the first final reads (its
frames, the stage-2 flows and occlusions of its jets, the stage-2 output's
other files) into a tree of the same layout at DEST, a few MB that another
machine can rerun stage 3 on. `--cmd` runs another stage-3 CLI with the same
cfg instead of the port's, as a child process (for example the reference
package's, on the saved tree, with `--device cpu`).
"""
from __future__ import annotations

import argparse
import json
import re
import shlex
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import bench_pipeline as bp
from .cli import dense_tracking
from .io import read_flo
from .runtime import resolve_device


def final_errors(out: Path, finals: int) -> list[float]:
    """dt_flow_err_px of each final's flow in the stage-3 output `out`."""
    errs = []
    for k in range(finals):
        start = bp.START + k * bp.DT_JETS * bp.STEPS
        flow = read_flo(out / f"frame_{start:04d}.flo")
        h, w = (bp.XY_INCR * n for n in flow.shape[:2])
        errs.append(bp.dt_flow_err(flow, h, w, start=start))
    return errs


def save_first_final(root: Path, dest: Path) -> list[str]:
    """Copy the files the first final of `root` reads into `dest` (same
    layout). Returns the copied paths, relative to `root`."""
    lo = bp.START
    hi = bp.START + bp.DT_JETS * bp.STEPS

    def wanted(path: Path) -> bool:
        nums = re.findall(r"\d+", path.stem)
        return not nums or lo <= int(nums[-1]) <= hi

    copied = []
    for sub in ("seq", "sf_out"):
        for src in sorted((root / sub).rglob("*")):
            rel = src.relative_to(root)
            if src.is_file() and wanted(src):
                (dest / rel).parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(src, dest / rel)
                copied.append(str(rel))
    return copied


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="a bench_pipeline run's tree (--out)")
    ap.add_argument("--finals", type=int, default=8)
    ap.add_argument("--seeds", default="3,1,2,4,5")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--out", help="write the record as JSON here")
    ap.add_argument("--device", default=None)
    ap.add_argument("--save-first-final", default=None, metavar="DEST")
    ap.add_argument("--cmd", default=None,
                    help="another stage-3 CLI to run on the cfg")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    root = Path(args.root)
    rec = {"root": str(root), "finals": args.finals, "seeds": {},
           "cmd": args.cmd}
    if args.save_first_final:
        rec["saved"] = save_first_final(root, Path(args.save_first_final))
    if device.type == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(rec["card"], flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = root / f"dt_seed{seed}"
        cfg = bp.stage3_cfg(root, args.finals)
        cfg = cfg.replace(f"{root}/dt_out", str(out))
        cfg = cfg.replace("seed\t3\n", f"seed\t{seed}\n")
        (root / f"dt_seed{seed}.cfg").write_text(cfg)
        t0 = time.perf_counter()
        cfg_path = str(root / f"dt_seed{seed}.cfg")
        if args.cmd:
            rc = subprocess.run([*shlex.split(args.cmd), cfg_path,
                                 "-threads", str(args.threads)]).returncode
        else:
            rc = dense_tracking.main([cfg_path, "-threads", str(args.threads),
                                      "-device", str(device)])
        if rc != 0:
            raise RuntimeError(f"stage 3 with seed {seed}: exit code {rc}")
        wall = time.perf_counter() - t0
        errs = final_errors(out, args.finals)
        rec["seeds"][seed] = {"wall_s": wall, "dt_flow_err_px": errs}
        print(f"seed {seed} ({wall:.1f} s): first final {errs[0]:.4f}; "
              "every final " + " ".join(f"{e:.4f}" for e in errs), flush=True)
    first = [r["dt_flow_err_px"][0] for r in rec["seeds"].values()]
    every = [e for r in rec["seeds"].values() for e in r["dt_flow_err_px"]]
    rec["first_final"] = dict(min=min(first), median=float(np.median(first)),
                              max=max(first))
    rec["every_final"] = dict(min=min(every), median=float(np.median(every)),
                              max=max(every))
    print(json.dumps({k: rec[k] for k in ("first_final", "every_final")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
