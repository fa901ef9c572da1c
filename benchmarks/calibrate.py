"""The readings that a cell's limits are set from, in one process on the
card (the benchmark's own runs do not run this):

  python3 -m benchmarks.calibrate --workload <cell> --seeds 11,12,... \
      [--control 3] [--seconds 4] [--out calib.json]

For each seed: the cell's set-up, a short window at the cell's own load
(`--seconds`), and the numbers compared between the sample of what the
window returned and the plain reference: the lower readings. For the
first `--control` seeds also the control, the reference computed in the
nearest precision below the configuration's (bfloat16 for its float32),
put in the program's place: the upper readings. A line of JSON per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from benchmarks import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    parts = harness.Parts(harness.BENCH_DIR, args.workload)
    config, driver = parts.config, parts.driver
    device = torch.device("cuda", 0)
    rows = []
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cell = driver.Cell(config, parts.traffic, seed, device)
        cell.warm()
        torch.cuda.synchronize()
        window = harness.run_window(cell, args.seconds,
                                    sync=torch.cuda.synchronize)
        picked = harness.sample(cell, window, seed)
        entries = [entry for _, _, entry in picked]
        got = harness.got(window, picked)
        t0 = time.perf_counter()
        want = cell.expected(entries)
        row = dict(seed=seed, calls=len(window.walls), compared=len(picked),
                   reference_s=time.perf_counter() - t0,
                   program={c["name"]: c["value"] for c in
                            driver.compare(got, want, config["checks"])})
        if n < args.control:
            low = cell.expected(entries, torch.bfloat16)
            row["control"] = {c["name"]: c["value"] for c in
                              driver.compare(low, want, config["checks"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del cell, window    # the graphs stay cached for the next seed
        torch.cuda.empty_cache()
    summary = dict(workload=args.workload, card=harness.power_limit(),
                   lower={k: max(r["program"][k] for r in rows)
                          for k in rows[0]["program"]},
                   upper={k: min(r["control"][k] for r in rows
                                 if "control" in r)
                          for k in rows[0]["program"]}
                   if args.control else {}, rows=rows)
    print(json.dumps({k: summary[k] for k in ("workload", "lower", "upper")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
