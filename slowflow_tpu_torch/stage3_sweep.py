"""Stage-3 measurements on one GPU: serial against F-batched final pairs, and
two (capacity, tryouts) points, at the bench shape.

    python3 -m slowflow_tpu_torch.stage3_sweep [--out PATH]

On the bench final pair of `bench_scene.stage3_final_pair` (270x480, Jets
10, EPIC hypotheses on; final pairs k = 0..3 are the scene with seed k):
- serial: one `track_final_pairs_batched` call per final, 4 finals; batched:
  F = 2 and F = 4 finals in one call. Wall seconds per final and the peak of
  `torch.cuda.max_memory_allocated()` per call; the batched flows against
  the serial ones (max |d| px, occlusion maps equal);
- (capacity, tryouts) = (16, 20), the default, and (8, 10) on final 0: wall
  seconds and `dt_flow_err_px`.
One warm-up call with 2 alternations first. Prints the card (nvidia-smi name
and power limit) and the record, and writes it as JSON to PATH when given.
Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from .bench_scene import dt_flow_err_px, stage3_config, stage3_final_pair
from .tracking.driver import track_final_pairs_batched


def _timed(cfg, jobs, device):
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    flows, occs, _ = track_final_pairs_batched(cfg, jobs, device=device)
    wall = time.perf_counter() - t0
    return flows, occs, wall, torch.cuda.max_memory_allocated(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the record as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage3_sweep: needs a CUDA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = stage3_config()
    scenes = [stage3_final_pair(seed=k, device=device) for k in range(4)]
    jobs = [job for job, _ in scenes]
    track_final_pairs_batched(replace(cfg, alternate=2), jobs[:1],
                              device=device)
    rec = dict(card=card, torch=torch.__version__, shape=[270, 480],
               jets=cfg.jets)

    serial = [_timed(cfg, [job], device) for job in jobs]
    rec["serial"] = dict(wall_s=[s[2] for s in serial],
                         peak_bytes=[s[3] for s in serial],
                         dt_flow_err_px=[dt_flow_err_px(s[0][0], gt)
                                         for s, (_, gt) in zip(serial,
                                                               scenes)])
    serial_walls = rec["serial"]["wall_s"]
    for F in (2, 4):
        flows, occs, wall, peak = _timed(cfg, jobs[:F], device)
        diff = max(float(np.abs(f - s[0][0]).max())
                   for f, s in zip(flows, serial))
        same_occ = all(np.array_equal(o, s[1][0])
                       for o, s in zip(occs, serial))
        rec[f"batched_F{F}"] = dict(
            wall_s=wall, wall_per_final_s=wall / F, peak_bytes=peak,
            serial_wall_per_final_s=float(np.mean(serial_walls[:F])),
            max_flow_diff_px=diff, occlusions_equal=same_occ)

    for capacity, tryouts in ((16, 20), (8, 10)):
        c = replace(cfg, capacity=capacity, hyp_neigh_tryouts=tryouts)
        flows, _, wall, peak = _timed(c, jobs[:1], device)
        rec[f"capacity{capacity}_tryouts{tryouts}"] = dict(
            wall_s=wall, peak_bytes=peak,
            dt_flow_err_px=dt_flow_err_px(flows[0], scenes[0][1]))

    for k, v in rec.items():
        print(f"{k}: {v}", flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
