"""Jets a second against the batch, on one card, for choosing the batch of
a jet cell (the benchmark's own runs do not run this):

  python3 -m benchmarks.batch_sweep --workload slowflow_1080q.b4 \
      --batches 1,2,4,8,16,32,64 --seconds 15 --seed <n> [--passes 2] \
      [--out sweep.json]

For each batch, in one process: the cell's set-up with its traffic mix at
that batch (the pool grown to the batch where it is smaller), then a
window of `--seconds` in a closed loop of one caller, read by the cell's
own `jets_per_s` and `batch_p90_ms` readers, and the card's peak memory.
A second pass runs the batches in the reverse order, so a drift of the
card's pace over the sweep shows as two readings that differ. A line of
JSON per batch and pass; the last line sums each batch up.
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
    ap.add_argument("--batches", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    parts = harness.Parts(harness.BENCH_DIR, args.workload)
    readers = {name: harness.load_part(harness.BENCH_DIR, "metrics", name,
                                       ".py")
               for name in ("jets_per_s", "batch_p90_ms")}
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)   # the allocator, before its statistics
    batches = [int(b) for b in args.batches.split(",")]
    rows = []
    for n in range(args.passes):
        for batch in batches if n % 2 == 0 else batches[::-1]:
            traffic = dict(parts.traffic, batch=batch, pool_jets=max(
                int(parts.traffic["pool_jets"]), batch))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            try:
                cell = parts.driver.Cell(parts.config, traffic, args.seed,
                                         device)
                cell.warm()
                torch.cuda.synchronize(device)
            except Exception as exc:    # a batch the card cannot take
                row = dict(batch=batch, sweep_pass=n, error=repr(exc))
                rows.append(row)
                print(json.dumps(row), flush=True)
                continue
            setup_s = time.perf_counter() - t0
            window = harness.run_window(cell, args.seconds,
                                        sync=torch.cuda.synchronize)
            rec = dict(window=window, unit=cell.unit)
            row = dict(batch=batch, sweep_pass=n, calls=len(window.walls),
                       setup_s=setup_s,
                       memory_peak_bytes=int(
                           torch.cuda.max_memory_allocated(device)),
                       failed=window.failed_units,
                       **{k: r.read(rec) for k, r in readers.items()})
            rows.append(row)
            print(json.dumps(row), flush=True)
            cell.release()
            del cell, window
    summary = dict(workload=args.workload, card=harness.power_limit(),
                   seconds=args.seconds, seed=args.seed,
                   jets_per_s={b: [r.get("jets_per_s") for r in rows
                                   if r["batch"] == b] for b in batches},
                   rows=rows)
    print(json.dumps({k: summary[k] for k in ("workload", "card",
                                              "jets_per_s")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
