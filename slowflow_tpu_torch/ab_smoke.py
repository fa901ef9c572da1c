"""Run chip_smoke.py, the bench-config slice alone, or K1 / K2 / K4 / K5
and the grid matcher alone, in turns on a parent tree and on this tree, on
one card.

    python3 -m slowflow_tpu_torch.ab_smoke PARENT_DIR [--rounds N]
    python3 -m slowflow_tpu_torch.ab_smoke PARENT_DIR --slice REPS [--batch B] [--rounds N]
    python3 -m slowflow_tpu_torch.ab_smoke PARENT_DIR --kernels REPS [--rounds N]
    python3 -m slowflow_tpu_torch.ab_smoke PARENT_DIR --phases NAME [...]

PARENT_DIR holds an unpacked tree of the commit to compare with (for
example `git archive HEAD | tar -x -C _archive/parent`, a directory that
.gitignore lists). Each round runs the parent, this tree, this tree, the
parent, so drift on the card falls on both alike. Each run's record
(chip_smoke.json in its tree's output directory, chip_smoke.OUT_DIR) is
copied to OUT_DIR/ab/<n>_<tag>.json beside its output, and one line per run is
printed: at 4x270x480, K1 (method 1, from zero, with sums), K2 (`assembly`
zero_duv, `occ_assembly`), K3 (each mode, with its device time), K4 (bench
flow and 20 px), K5 and K6's entry by CUDA events, K4 / K6 also by device
time beside grid_sample's on the same planes; the merged and stack slices'
wall time per batch of 4, the merged slice's device idle share (profiled
device busy time over the unprofiled wall time), the stack slice's device
busy time and its K3 / K4 device time per slice, and both routes'
flow_recovery_err_px. Exits non-zero if a run fails.

With --slice, each turn is a fresh process that imports that tree's
slowflow_tpu_torch, solves the merged-route slice of chip_smoke.py (bench
config, --batch jets, 270x480, the scene of this tree's bench_scene.py) once to
warm up and REPS times on the clock, then once under torch.profiler for
the device busy time; it prints the median and every wall time, and the
idle share against the median. A last solve, off the clock, records the
digest of its flow (wx, wy, occlusions) and, per pyramid level, the digest
of the level's flow and the outer iterations each jet took (a jet takes
an outer iteration while it is live: its change above thres_outer);
the summary says whether the flows and the levels' iterations agree in
every run.

With --kernels, each turn is a fresh process that imports that tree's
slowflow_tpu_torch and times, on the same seeded inputs at 4 x 270 x 480
(K4: the 4 x 5 x 3 window), K1 `solve_step` (smoothing 1, zero start,
change sums, 30 sweeps), K2 `warp_assemble` (`assembly` and `occ_assembly`,
zero du / dv), K4 `warp_stack` (a bench-like flow) and K5
`sor_coupled_rb_pallas` (30 sweeps); K1 and K5 again at SOLVE_SHAPES, the
grouped and row-streamed paths' shapes, each with the digest of its du /
dv, which must agree between the trees (K1's sums' digests are kept
beside them: their band partials follow the plan), and each shape's group
and HBM floors (`solve_floors`); and the grid matcher
(`epic.matching.grid_match`, both directions, patch radius 4, the grid of
step 8) at chip_smoke's phase 5 shape (4 x 270 x 480, radius 50) and
stage 1's (40 x 270 x 480, radius 32) on the scene of this tree's
bench_scene.py, each by CUDA events over REPS calls after a warm-up and by
the profiler's device time (10 calls, a capture retaken until it holds
every launch: one a call, two for the matcher's two directions); the
matcher's entries also carry a digest of both directions' labels, which
must agree between the trees. The last line holds the medians per tree.

With --phases, each turn is a fresh process that imports that tree's
chip_smoke.py and runs its kernel build and then the named phases (any of
its phase functions that both trees have, such as cli_stage2_epic and
stage1), and prints one line per run with the phases' records: for
cli_stage2_epic the wall and solve per batch, the matcher's seconds and
the matches kept per jet with and without the EPIC init, for stage1 the
wall, the quantile and the `af.*` seconds; every record is kept in
OUT_DIR/ab/phases_summary.json.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BENCH = [4, 270, 480]
# --kernels: K1 / K5 on every regime of csrc/solve_step.cu (resident at the
# bench shape; grouped; row-streamed at 1080p and 2160 x 3840)
SOLVE_SHAPES = (("K1", (4, 270, 480)), ("K1", (8, 270, 480)),
                ("K1", (16, 270, 480)), ("K1", (4, 540, 960)),
                ("K1", (1, 1080, 1920)), ("K1", (1, 2160, 3840)),
                ("K5", (4, 270, 480)), ("K5", (40, 270, 480)))


def _out_dir() -> Path:
    """chip_smoke.py's output directory (gitignored)."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import OUT_DIR

    return OUT_DIR


def _row(record, name, **match):
    for r in record.get("kernels_vs_twins", {}).get(name, []):
        if r["shape"] == BENCH and all(r.get(k) == v for k, v in match.items()):
            return r
    return {}


def _family_ms(profile, name) -> float | None:
    """Device ms per slice of the kernels whose name contains `name`, from
    a route profile's top kernels."""
    top = profile.get("top_kernels_ms")
    return None if top is None else sum(ms for n, ms in top if name in n)


def summary(record) -> dict:
    slices = record.get("slices", {})
    profiles = record.get("profiles", {})
    prof = profiles.get("merged", {})
    wall = slices.get("merged", {}).get("kernel_wall_s")
    busy = prof.get("device_busy_ms")
    k3 = {f"k3_{mode}{'_zero_duv' if z else ''}": _row(
        record, "fused_data", mode=mode, zero_duv=z)
        for mode, z in (("assembly", True), ("assembly", False),
                        ("occ", True), ("occ_assembly", True))}
    k4 = _row(record, "warp_stack", motion="bench")
    k4_20 = _row(record, "warp_stack", motion="20px")
    k6 = _row(record, "warp_stack_pallas")
    return {
        "k1_ms": _row(record, "solve_step", method=1, zero_init=True).get("ms"),
        "k2_assembly_zero_duv_ms": _row(record, "warp_assemble",
                                        mode="assembly", zero_duv=True).get("ms"),
        "k2_occ_assembly_ms": _row(record, "warp_assemble",
                                   mode="occ_assembly").get("ms"),
        **{f"{k}_ms": r.get("ms") for k, r in k3.items()},
        **{f"{k}_device_ms": r.get("device_ms") for k, r in k3.items()},
        "k4_ms": k4.get("ms"), "k4_device_ms": k4.get("device_ms"),
        "k4_grid_sample_ms": k4.get("library_ms"),
        "k4_grid_sample_device_ms": k4.get("library_device_ms"),
        "k4_20px_ms": k4_20.get("ms"), "k4_20px_device_ms": k4_20.get("device_ms"),
        "k4_20px_grid_sample_device_ms": k4_20.get("library_device_ms"),
        "k6_ms": k6.get("ms"), "k6_device_ms": k6.get("device_ms"),
        "k6_grid_sample_ms": k6.get("library_ms"),
        "k6_grid_sample_device_ms": k6.get("library_device_ms"),
        "k5_ms": _row(record, "sor").get("ms"),
        "merged_wall_s": wall,
        "stack_wall_s": slices.get("stack", {}).get("kernel_wall_s"),
        "merged_device_busy_ms": busy,
        "merged_idle_share": None if not (wall and busy)
        else 1 - busy / (wall * 1e3),
        "stack_device_busy_ms": profiles.get("stack", {}).get("device_busy_ms"),
        "stack_k3_ms_per_slice": _family_ms(profiles.get("stack", {}),
                                            "fused_data_kernel"),
        "stack_k4_ms_per_slice": _family_ms(profiles.get("stack", {}),
                                            "warp_stack_kernel"),
        "merged_flow_recovery_err_px":
            slices.get("merged", {}).get("flow_recovery_err_px"),
        "stack_flow_recovery_err_px":
            slices.get("stack", {}).get("flow_recovery_err_px"),
    }


SLICE = """
import hashlib, importlib.util, json, statistics, sys, time
sys.path.insert(0, {tree!r})
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
spec = importlib.util.spec_from_file_location("scene", {scene!r})
scene = importlib.util.module_from_spec(spec)
spec.loader.exec_module(scene)
from slowflow_tpu_torch.variational import multiframe
from slowflow_tpu_torch.variational.params import MultiFrameParams
p = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0, rho=(1.0, 1.0),
                     omega=(0.0, 2.0), layers=5, p_scale=0.9, niter_alter=10,
                     niter_outer=10, niter_inner=1, niter_solver=30,
                     occlusion_reasoning=True, smoothing=1)
dev, (b, h, w) = torch.device("cuda"), ({batch}, 270, 480)
seq = torch.tensor(np.stack([scene.moving_sequence(5, h, w, 1.5 + 0.2 * s,
                                                   -0.8, seed=s)
                             for s in range(b)]), device=dev)
zero = torch.zeros((b, h, w), device=dev)
def solve():
    out = multiframe.variational_mt_batched(zero, zero, seq, p, device=dev)
    torch.cuda.synchronize()
    return out
solve()
walls = []
for _ in range({reps}):
    t0 = time.perf_counter()
    wx = solve()[0]
    walls.append(time.perf_counter() - t0)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    solve()
busy = sum(e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == DeviceType.CUDA) / 1e3
# off the clock: the flow's digest, and per level its digest and the outer
# iterations of each jet (the jets live as each outer solve starts)
def digest(planes):
    return hashlib.sha256(b"".join(
        x.cpu().numpy().tobytes() for x in planes)).hexdigest()[:16]
levels, drive = [], multiframe._Level.drive
level_fn = multiframe.compute_one_level
def counted_drive(self, run):
    outer = torch.zeros(b, dtype=torch.int64)
    def counting(segment, fn):
        if segment[0] == "outer" or (segment[0] == "top" and self.fuse_occ):
            flags = self.st.live if segment[0] == "outer" else self.st.alive
            outer.add_(flags.cpu().long())
        run(segment, fn)
    drive(self, counting)
    levels.append(dict(hw=list(self.st.wx.shape[1:]),
                       outer_per_jet=outer.tolist()))
def digested_level(*args, **kw):
    out = level_fn(*args, **kw)
    levels[-1]["flow_digest"] = digest(out)
    return out
multiframe._Level.drive = counted_drive
multiframe.compute_one_level = digested_level
flow_digest = digest(solve())
print(json.dumps(dict(walls=walls, median_s=statistics.median(walls),
                      busy_ms=busy, idle_share=1 - busy / (
                          statistics.median(walls) * 1e3),
                      flow_recovery_err_px=abs(float(
                          wx[0, 8:-8, 8:-8].median()) - 1.5),
                      flow_digest=flow_digest, levels=levels)))
"""


KERNELS = """
import hashlib, importlib.util, json, sys
sys.path.insert(0, {tree!r})
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
spec = importlib.util.spec_from_file_location("scene", {scene!r})
scene = importlib.util.module_from_spec(spec)
spec.loader.exec_module(scene)
from slowflow_tpu_torch.core.image import luminance
from slowflow_tpu_torch.epic.matching import grid_match
from slowflow_tpu_torch.core.solver_pallas import sor_coupled_rb_pallas
from slowflow_tpu_torch.core.warp_shift import warp_stack
from slowflow_tpu_torch.variational.fused_solve import solve_step
from slowflow_tpu_torch.variational.fused_warp import warp_assemble
from slowflow_tpu_torch.variational.params import MultiFrameParams
dev, (b, h, w) = torch.device("cuda"), (4, 270, 480)
rng = np.random.default_rng(0)
def planes(n, scale=1.0, shift=0.0):
    return [torch.tensor(rng.normal(0, scale, (b, h, w)) + shift,
                         dtype=torch.float32, device=dev) for _ in range(n)]
p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), smoothing=1)
reg = p.penalties()[2]
uu, vv, b1, b2 = planes(4)
dpsis, a11, a22, wh, wv = (x.abs() * 0.5 + 0.2 for x in planes(5))
a12, du, dv = planes(3, 0.1)
seq = torch.tensor(rng.random((b, 5, 3, h, w)) * 255, dtype=torch.float32,
                   device=dev)
wx, wy = planes(2, 1.5, 0.5)
cw = torch.ones((b, 3, h, w), device=dev)
occ = planes(1)[0].sign()
digests = {{}}
# K1 (smoothing 1, zero start, sums) or K5 (from du, dv != 0), 30 sweeps,
# on seeded planes of [nb, nh, nw]; the digest of du / dv (and of K1's
# sums) of one call
def solve_calls(kernel, nb, nh, nw):
    g = np.random.default_rng(nb * 100003 + nh * 101 + nw)
    x = [torch.tensor(g.normal(0, 1, (nb, nh, nw)), dtype=torch.float32,
                      device=dev) for _ in range(12)]
    uu, vv, b1, b2 = x[:4]
    dpsis, a11, a22, wh, wv = (y.abs() * 0.5 + 0.2 for y in x[4:9])
    a12, du, dv = (0.1 * y for y in x[9:12])
    fn = (lambda: solve_step(
        uu, vv, dpsis, a11, a12, a22, b1, b2, alpha=4.0, reg_pen=reg,
        method=1, iterations=30, omega=1.9, with_change=True)) \
        if kernel == "K1" else (lambda: sor_coupled_rb_pallas(
            du, dv, a11, a12, a22, b1, b2, wh, wv, iterations=30,
            omega=1.9))
    out = [o.cpu().numpy().tobytes() for o in fn()]
    shape = f"{{kernel}} {{nb}}x{{nh}}x{{nw}}"
    digests[shape + " du/dv"] = hashlib.sha256(
        b"".join(out[:2])).hexdigest()[:16]
    if kernel == "K1":
        sums[shape] = hashlib.sha256(out[2]).hexdigest()[:16]
    return fn
sums = {{}}
calls = {{
    "K1 solve_step": lambda: solve_step(
        uu, vv, dpsis, a11, a12, a22, b1, b2, alpha=4.0, reg_pen=reg,
        method=1, iterations=30, omega=1.9, with_change=True),
    "K2 warp_assemble": lambda: warp_assemble(
        seq, wx, wy, occ, None, None, cw, p, mode="assembly", zero_duv=True),
    "K2 occ_assembly": lambda: warp_assemble(
        seq, wx, wy, None, None, None, cw, p, mode="occ_assembly",
        zero_duv=True),
    "K4 warp_stack": lambda: warp_stack(seq, wx, wy, 2),
    "K5 sor": lambda: sor_coupled_rb_pallas(
        du, dv, a11, a12, a22, b1, b2, wh, wv, iterations=30, omega=1.9),
}}
for kernel, shape in {SOLVE_SHAPES!r}:
    calls[f"{{kernel}} {{'x'.join(map(str, shape))}}"] = solve_calls(
        kernel, *shape)
def matcher(nb, r):
    seq = np.round(np.stack([scene.moving_sequence(4, h, w, 1.5 + 0.2 * s,
                                                   -0.8, seed=s)[2:4]
                             for s in range(nb)]))
    pairs = torch.tensor(seq, dtype=torch.float32, device=dev)
    g1, g2 = (luminance(pairs[:, i].contiguous()) for i in (0, 1))
    gy, gx = np.mgrid[4:h:8, 4:w:8]
    ys, xs = (torch.as_tensor(a.ravel(), device=dev).expand(nb, -1)
              .contiguous() for a in (gy, gx))
    d = 2 * r + 1
    kf = grid_match(g1, g2, ys, xs, r, 4)
    y2 = (ys + kf // d - r).clamp(0, h - 1)
    x2 = (xs + kf % d - r).clamp(0, w - 1)
    kb = grid_match(g2, g1, y2, x2, r, 4)
    digests[f"{{nb}}x{{h}}x{{w}} r{{r}}"] = hashlib.sha256(
        torch.cat([kf, kb]).cpu().numpy().tobytes()).hexdigest()[:16]
    return lambda: (grid_match(g1, g2, ys, xs, r, 4),
                    grid_match(g2, g1, y2, x2, r, 4))
calls["K7 grid_match 4x270x480 r50"] = matcher(4, 50)
calls["K7 grid_match 40x270x480 r32"] = matcher(40, 32)
def device_ms(fn, launches, reps=10):
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(evs) >= reps * launches:
            return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3
    raise RuntimeError(f"{{len(evs)}} kernel records for {{reps}} calls")
out = {{}}
for name, fn in calls.items():
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range({reps}):
        fn()
    end.record()
    torch.cuda.synchronize()
    out[name] = dict(ms=start.elapsed_time(end) / {reps},
                     device_ms=device_ms(fn, 2 if "K7" in name else 1))
out["labels"] = digests
out["sums"] = sums
print(json.dumps(out))
"""


PHASES = """
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as c
c.OUT_DIR.mkdir(exist_ok=True)
for name in ("build", *{phases!r}):
    c.phase(getattr(c, name))
print(json.dumps(dict(failures=c.FAILURES, record={{
    name: c.RECORD.get(name) for name in {phases!r}}}), default=str))
"""


def solve_floors() -> dict:
    """The plan and the group and HBM floors (fused_solve.solve_floors) of
    each --kernels K1 / K5 shape at 30 sweeps, from this tree's kernel
    library on the current card."""
    from .variational.fused_solve import solve_floors, solve_plan

    out = {}
    for kernel, shape in SOLVE_SHAPES:
        plan = solve_plan(*shape)
        out[f"{kernel} {'x'.join(map(str, shape))}"] = dict(
            regime=plan.regime, group=plan.group, groups=plan.groups,
            **solve_floors(plan, *shape, 30))
    return out


def _phase_line(result: dict) -> dict:
    """The numbers of a --phases run that a parent / change line shows."""
    rec = result.get("record", {})
    out = {}
    for dm, r in (rec.get("cli_stage2_epic") or {}).items():
        ph = r.get("phases", {})
        out[dm] = dict(wall_per_batch_s=r.get("wall_per_batch_s"),
                       solve_per_batch_s=r.get("solve_per_batch_s"),
                       matches_s=ph.get("sf.matches", [None])[0],
                       init_wait_s=ph.get("sf.init_wait", [None])[0],
                       matches_kept=r.get("matches_kept"),
                       flo_digest=r.get("flo_digest"),
                       flow_recovery_err_px=r.get("flow_recovery_err_px"))
    st = rec.get("stage1")
    if st:
        out["stage1"] = dict(wall_s=st.get("wall_s"), quantil=st.get(
            "quantil"), **{k: v[0] for k, v in st.get("phases", {}).items()
                           if k.startswith("af.")})
    return dict(failures=result.get("failures"), **out)


def run_slice(tree: Path, tag: str, n: int, reps: int,
              template: str = SLICE, show: bool = True, **fields) -> dict:
    code = template.format(tree=str(tree), reps=reps, scene=str(
        HERE / "slowflow_tpu_torch" / "bench_scene.py"),
        SOLVE_SHAPES=SOLVE_SHAPES, **fields)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    result = json.loads(proc.stdout.strip().splitlines()[-1]) \
        if proc.returncode == 0 else {"stderr": proc.stderr[-2000:]}
    line = dict(run=n, tree=tag, rc=proc.returncode, **result)
    if show:
        print(json.dumps(line), flush=True)
    return line


def run(tree: Path, tag: str, n: int, out: Path) -> dict:
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          capture_output=True, text=True, timeout=1300)
    (out / f"{n}_{tag}.log").write_text(proc.stdout + proc.stderr)
    record_path = tree / _out_dir().name / "chip_smoke.json"
    record = json.loads(record_path.read_text()) if record_path.exists() \
        else {}
    if record_path.exists():
        shutil.copy(record_path, out / f"{n}_{tag}.json")
    line = dict(run=n, tree=tag, rc=proc.returncode, **summary(record))
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--slice", type=int, default=0, metavar="REPS",
                    help="time the merged slice REPS times per turn instead "
                         "of running chip_smoke.py")
    ap.add_argument("--phases", nargs="+", metavar="NAME",
                    help="run these chip_smoke.py phases per turn instead "
                         "of the whole script")
    ap.add_argument("--batch", type=int, default=4,
                    help="jets a batch of --slice (default 4)")
    ap.add_argument("--kernels", type=int, default=0, metavar="REPS",
                    help="time K1 / K2 / K4 / K5 and the matcher over REPS "
                         "calls per turn instead of running chip_smoke.py")
    args = ap.parse_args(argv)
    out = _out_dir() / "ab"
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lines, records = [], []
    for r in range(args.rounds):
        for tag in ("parent", "change", "change", "parent"):
            tree = args.parent.resolve() if tag == "parent" else HERE
            if args.phases:
                full = run_slice(tree, tag, len(lines), 0, PHASES,
                                 show=False, phases=tuple(args.phases))
                records.append(full)
                lines.append(dict(run=full["run"], tree=tag, rc=full["rc"],
                                  **_phase_line(full)))
                print(json.dumps(lines[-1]), flush=True)
            elif args.kernels:
                lines.append(run_slice(tree, tag, len(lines), args.kernels,
                                       KERNELS))
            elif args.slice:
                lines.append(run_slice(tree, tag, len(lines), args.slice,
                                       batch=args.batch))
            else:
                lines.append(run(tree, tag, len(lines), out))
    record = dict(card=smi, runs=lines)
    if args.kernels and all(line["rc"] == 0 for line in lines):
        record["median"] = {tree: {k: {m: statistics.median(
            line[k][m] for line in lines if line["tree"] == tree)
            for m in ("ms", "device_ms")} for k in lines[0] if " " in k}
            for tree in ("parent", "change")}
        record["labels_agree"] = len({json.dumps(line.get("labels"))
                                      for line in lines}) == 1
        record["solve_floors"] = solve_floors()
        print(json.dumps(record["median"]))
        print(json.dumps(record["solve_floors"]))
        print(f"matcher labels and K1 / K5 du / dv equal in every run: "
              f"{record['labels_agree']}")
    if args.slice and all(line["rc"] == 0 for line in lines):
        record["flows_agree"] = len({line["flow_digest"]
                                     for line in lines}) == 1
        record["levels_agree"] = len({json.dumps(line["levels"])
                                      for line in lines}) == 1
        print(f"flows equal in every run: {record['flows_agree']}; levels' "
              f"flows and outer iterations: {record['levels_agree']}")
    if args.phases:
        record["records"] = records
    name = "phases_summary.json" if args.phases else \
        "kernels_summary.json" if args.kernels else \
        f"slice_b{args.batch}_summary.json" if args.slice else "summary.json"
    (out / name).write_text(json.dumps(record, indent=1))
    ok = all(line["rc"] == 0 and not line.get("failures") for line in lines)
    return 0 if ok and record.get("labels_agree", True) else 1


if __name__ == "__main__":
    sys.exit(main())
