"""The benchmark's plumbing: finding a cell's files by name, the measured
window, the profiler's records, and the result line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by the name that
`BENCHMARK.json` (at the root of the checkout) or a configuration file
gives it:

  configs/<config>.json      the configuration: its cfg keys, `driver`
  traffic/<traffic>.json     the traffic mix: its `generator` and parameters
  generators/<generator>.py  makes a mix's inputs on the device from a seed
  drivers/<driver>.py        the system under test and the comparison that
                             decides `correct`
  metrics/<metric>.py        one reader per per-layer metric
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent

# modules that must not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "slowflow_tpu", "bench")

# host calls that put work on the device: kernel launches (the cooperative
# ones included) and graph replays
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_spec(bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir.parent / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"(have {[c['name'] for c in spec['workloads']]})")


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def import_file(path: Path, name: str | None = None):
    """The module in `path`, loaded under a name of its own (metric files
    are named after metrics, which hold dots)."""
    name = name or "benchmarks._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_part(bench_dir: Path, folder: str, name: str, suffix: str):
    path = bench_dir / folder / f"{name}{suffix}"
    if not path.exists():
        raise SystemExit(f"{folder[:-1]} {name!r}: no file {path}")
    return load_json(path) if suffix == ".json" else import_file(path)


class Parts:
    """The files of one cell, found by the names in BENCHMARK.json: the
    spec, the cell's entry, its configuration, traffic mix and driver."""

    def __init__(self, bench_dir: Path, workload: str):
        self.spec = load_spec(bench_dir)
        self.cell = find_cell(self.spec, workload)
        self.config = load_part(bench_dir, "configs", self.cell["config"],
                                ".json")
        self.traffic = load_part(bench_dir, "traffic", self.cell["traffic"],
                                 ".json")
        self.driver = load_part(bench_dir, "drivers", self.config["driver"],
                                ".py")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def graph_captures() -> int:
    """CUDA graphs the port has captured in this process so far."""
    from slowflow_tpu_torch.variational import graphs

    return int(graphs.STATS["captures"])


def quantile(values, q: int, n: int) -> float:
    """The q-th of the n-quantiles of `values` (Python's inclusive
    method); the one value itself where there is one."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=n, method="inclusive")[q - 1])


def sample(cell, window, seed: int) -> list[tuple[int, int, int]]:
    """(call, place in the call, pool entry) of the results to compare:
    `traffic["check"]` of them drawn from the seed among the results of
    the calls that returned."""
    import numpy as np

    done = [(i, k, entry) for i, out in enumerate(window.outputs)
            if out is not None for k, entry in enumerate(cell.entries(i))]
    rng = np.random.default_rng(int(seed))
    n = min(int(cell.traffic["check"]), len(done))
    return [done[t] for t in sorted(rng.choice(len(done), n, replace=False))]


def got(window, picked) -> list:
    """The program's outputs of the picked results, each output stacked
    over them (a call returns its outputs with the call's entries first)."""
    import numpy as np

    outs = [(window.outputs[i], k) for i, k, _ in picked]
    return [np.stack([out[a][k] for out, k in outs])
            for a in range(len(outs[0][0]))]


def check(cell, compare, window, seed: int) -> list[dict]:
    """Each number compared between a sample of what the window returned
    and the cell's plain reference, with its limit; empty if no call
    returned."""
    picked = sample(cell, window, seed)
    if not picked:
        return []
    want = cell.expected([entry for _, _, entry in picked])
    return compare(got(window, picked), want, cell.config["checks"])


class Window:
    """What the measured window saw: each call's wall seconds, its units of
    work, and its output or error."""

    def __init__(self):
        self.walls: list[float] = []
        self.units: list[int] = []
        self.outputs: list = []
        self.failed_units = 0
        self.seconds = 0.0
        self.trace = None


def run_window(cell, seconds: float, *, trace_calls: int = 0,
               sync=lambda: None) -> Window:
    """Calls the cell's unit of work in a closed loop, one caller, until the
    first call that completes at or after `seconds`. With `trace_calls`,
    the first that many calls run under the profiler (`Trace`), whose
    records are read once the window has closed; the window's seconds
    leave out the profiler's teardown, so untraced calls follow."""
    win = Window()
    tracer = Trace(cell) if trace_calls else None
    if tracer is not None:
        tracer.start()      # the profiler's own start-up is not timed
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        units = cell.units(i)
        try:
            out = cell.call(i)
        except Exception:
            if win.failed_units == 0:
                traceback.print_exc()
            out = None
            win.failed_units += units
        sync()
        t1 = time.perf_counter()
        win.walls.append(t1 - t0)
        win.units.append(units)
        win.outputs.append(out)
        i += 1
        if tracer is not None and i == trace_calls:
            t_stop = time.perf_counter()
            tracer.stop(i, sum(win.units))
            # the profiler's teardown (tens of seconds for tens of
            # thousands of records) is no part of the window
            t_start += time.perf_counter() - t_stop
        if t1 - t_start >= seconds:
            break
    win.seconds = time.perf_counter() - t_start
    if tracer is not None:
        tracer.stop(i, sum(win.units))
        win.trace = tracer.read()
    return win


class Trace:
    """torch.profiler over the first calls of the window, with the cell's
    own spans and counters (`cell.tracing()`) open around it. It records
    the device's activity (kernels, copies, and the host's CUDA API
    calls); the host's operators and spans only where the mix asks for
    them (`trace_host_ops`), since recording each operator slows the host
    that feeds the device."""

    def __init__(self, cell):
        self.cell = cell
        self.prof = self.calls = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.scope = self.cell.tracing()
        self.counts = self.scope.__enter__()
        activities = [ProfilerActivity.CUDA]
        if self.cell.traffic.get("trace_host_ops"):
            activities.append(ProfilerActivity.CPU)
        torch.cuda.synchronize()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, calls: int, units: int):
        """Ends the profiler after `calls` calls of `units` units (once)."""
        import torch

        if self.prof is None or self.calls is not None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.scope.__exit__(None, None, None)
        self.calls, self.units = calls, units

    def read(self) -> dict:
        """The profiler's records (read after the window: reading them takes
        seconds), the traced calls, their units and seconds, and the
        cell's counters."""
        return dict(events=raw_events(self.prof),
                    kernels=kernel_launches(self.prof),
                    window_s=self.window_s, calls=self.calls,
                    units=self.units, counts=self.counts)


def raw_events(prof) -> list[tuple]:
    """(name, on the device, start ns, end ns) of every record of a
    finished profiler run, as the profiler keeps them (building its event
    objects takes far longer)."""
    from torch.autograd import DeviceType

    return [(ev.name(), ev.device_type() == DeviceType.CUDA, ev.start_ns(),
             ev.end_ns()) for ev in prof.profiler.kineto_results.events()]


def kernel_launches(prof) -> list[tuple]:
    """(name, start ns, end ns, grid, block) of every kernel record of a
    finished profiler run. The launch configuration is only in the
    profiler's exported trace: it is written to a temporary file of the
    traced calls alone, read and deleted."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = load_json(Path(path))
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = []
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        args = ev.get("args", {})
        start = round(float(ev["ts"]) * 1e3)
        out.append((ev["name"], start, start + round(float(ev["dur"]) * 1e3),
                    tuple(args.get("grid", ())), tuple(args.get("block", ()))))
    return out


def device_kernels(events) -> list[tuple]:
    """The device's kernel records: no memcpy / memset, and not the device
    rows that the profiler mirrors a host span's name into."""
    host = {e[0] for e in events if not e[1]}
    return [e for e in events if e[1] and e[0] not in host
            and not e[0].startswith(("Memcpy", "Memset"))]


def busy_intervals(events) -> list[tuple]:
    """The union of the device's kernel intervals, in ns, sorted."""
    spans = sorted((e[2], e[3]) for e in device_kernels(events))
    merged: list[list] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy_seconds(events) -> float:
    return sum(b - a for a, b in busy_intervals(events)) / 1e9


def idle_pct(rec):
    """The device's idle share of the traced work at the window's untraced
    pace, in percent: its kernels' busy seconds (the profiler does not
    stretch a kernel) against the seconds that the window's untraced
    calls took for as many units (the profiler does stretch the host's
    launches and graph replays). None where nothing was traced or no
    untraced call followed."""
    if rec.get("events") is None:
        return None
    win, k = rec["window"], rec["calls"]
    rest = sum(win.units[k:])
    busy = busy_seconds(rec["events"])
    if not rest or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (sum(win.walls[k:]) / rest * rec["units"]))


def breakdown(events, top: int = 10, labelled: int = 200) -> dict:
    """The device operations that took most time, and the idle time of the
    `labelled` longest gaps between kernels, summed by the innermost host
    record open at each gap's middle."""
    import numpy as np

    by_name: dict = {}
    for name, _, a, b in device_kernels(events):
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(events)
    gaps = sorted(((start - end, (start + end) / 2) for (_, end), (start, _)
                   in zip(busy, busy[1:])), reverse=True)[:labelled]
    host = [e for e in events if not e[1]]
    names = [e[0] for e in host]
    starts = np.array([e[2] for e in host], np.int64)
    ends = np.array([e[3] for e in host], np.int64)
    idle: dict = {}
    for length, mid in gaps:
        open_ = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = "(no host record)" if open_.size == 0 else \
            names[open_[np.argmin(ends[open_] - starts[open_])]]
        idle[label] = idle.get(label, 0.0) + length / 1e9
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[n[:120], s] for n, s in ops],
                idle_gaps=[[n[:120], s] for n, s in gaps_by])


def device_info(device, count: int) -> dict:
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
