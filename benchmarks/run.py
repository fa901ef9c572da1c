"""Run one cell of the benchmark once.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Set-up (imports, the inputs made from the seed, the warm-up call that
builds the kernels and captures the graphs) is `setup_s`; then the cell's
unit of work runs in a closed loop until the first call that completes at
or after `--seconds`. With `--trace 0` the result holds the cell's
end-to-end metrics; with `--trace 1` the first calls of the window run
under the profiler and the result holds its per-layer metrics. After the
window the program's state is freed and a sample of what the window
returned is compared with the plain reference, which decides `correct`.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each with its limit.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmarks import harness  # noqa: E402


def _cache_dirs(repo: Path) -> None:
    """Build and kernel caches at fixed places inside the checkout (the
    port's own kernels build into slowflow_tpu_torch/_build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(repo / "_bench_cache" / sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, bench_dir: Path = harness.BENCH_DIR,
         device=None) -> int:
    """`device` None: the cell's card(s), and no result without them; a
    device given (the CPU tests) skips that look."""
    args = parse(argv)
    parts = harness.Parts(bench_dir, args.workload)
    spec, cell_spec, config = parts.spec, parts.cell, parts.config
    _cache_dirs(bench_dir.parent)

    import torch

    if device is None:
        chips = int(cell_spec["chips"])
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    cell = parts.driver.Cell(config, parts.traffic, args.seed, device,
                             bench_dir)
    cell.warm()
    sync()
    setup_s = time.perf_counter() - T0

    kind = "per_layer" if args.trace else "end_to_end"
    trace_calls = int(parts.traffic.get("trace_calls", 1)) \
        if args.trace else 0
    captures = harness.graph_captures()
    window = harness.run_window(cell, args.seconds, trace_calls=trace_calls,
                                sync=sync)
    captures = harness.graph_captures() - captures
    device_rec = harness.device_info(device, 1) if on_card else \
        dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    cell.release()

    rec = dict(window=window, setup_s=setup_s, unit=cell.unit,
               config=config, traffic=parts.traffic, cell=cell_spec)
    if window.trace is not None:
        rec.update(window.trace)
        device_rec.update(busy_s=harness.busy_seconds(window.trace["events"]),
                          window_s=window.trace["window_s"])
    metrics = {}
    for m in harness.cell_metrics(spec, args.workload, kind):
        reader = harness.load_part(bench_dir, "metrics", m["name"], ".py")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    result = dict(correct=False, attempted=int(sum(window.units)),
                  failed=int(window.failed_units), metrics=metrics,
                  device=device_rec)
    if window.trace is not None:
        result["breakdown"] = harness.breakdown(window.trace["events"])

    checks = harness.check(cell, parts.driver.compare, window, args.seed)
    result["correct"] = bool(checks) and window.failed_units == 0 and all(
        c["value"] <= c["limit"] for c in checks)
    result["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                        for c in checks}

    found = harness.forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 4
    card = harness.power_limit() if on_card else "cpu"
    print(f"{args.workload} seed {args.seed}: {len(window.walls)} calls in "
          f"{window.seconds:.3f} s, set-up {setup_s:.3f} s, {captures} graph "
          f"captures in the window; {card}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    if not checks:
        print("check: no call of the window returned", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
