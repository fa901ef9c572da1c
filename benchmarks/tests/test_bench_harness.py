"""The harness on the CPU at tiny sizes: discovery by name, the generators,
the per-layer readers on a recorded profile, the result line, the
yardstick's counts, the reference against the port, and `correct` coming
out false for the control and for a timed path broken underneath.

A later PR that adds a cell appends it, with files of its own, and does not
edit this file: the contract is checked on whatever BENCHMARK.json holds,
and the cells accepted so far (`ACCEPTED`) are held as its first cells."""
import copy
import json
import re
import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from benchmarks import harness, kernel_share, run, work

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# the cells accepted so far, in the order they matter; later cells are
# appended after them
ACCEPTED = ["slowflow_1080q.b4", "tracking_1080q.f1", "slowflow_1080q.b1",
            "slowflow_1080q.b64"]

# tiny cuts of the two configurations (run here on the CPU only)
TINY_SF = dict(height=40, width=56, cfg=dict(
    slow_flow_layers="2", slow_flow_niter_alter="3",
    slow_flow_niter_outer="3", slow_flow_niter_solver="10"))
TINY_DT = dict(height=48, width=64, cfg=dict(
    Jets="4", acc_alternate="2", acc_hyp_neigh_tryouts="8",
    acc_capacity="8"))


def tiny(config: str, cut: dict) -> dict:
    out = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    out.update(height=cut["height"], width=cut["width"])
    out["cfg"].update(cut["cfg"])
    return out


def make_root(tmp_path: Path, cells: list[dict], configs: dict,
              traffic: dict) -> Path:
    """A checkout (BENCHMARK.json and benchmarks/) with cells appended as a
    later PR appends them: configuration and traffic files of their own
    beside the committed ones, each cell's entry and its configuration's
    appended to BENCHMARK.json, and the cell's name appended to the
    `workloads` list of every metric that lists the committed cell named
    by the cell's `like`."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = copy.deepcopy(SPEC)
    for name, cfg in configs.items():
        path = root / "benchmarks" / "configs" / f"{name}.json"
        assert not path.exists(), path
        path.write_text(json.dumps(cfg))
        spec["configs"].append(dict(
            name=name, source=cfg["source"],
            file=str(path.relative_to(root)),
            reduced=["height", "width", "cfg"],
            why="a tiny cut of a configuration for the CPU tests"))
    for name, mix in traffic.items():
        path = root / "benchmarks" / "traffic" / f"{name}.json"
        assert not path.exists(), path
        path.write_text(json.dumps(mix))
    for cell in cells:
        cell = dict(cell)
        like = cell.pop("like")
        spec["workloads"].append(cell)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_cell(root: Path, cell: str, capsys, seed=3000000017, seconds=0.5):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0"],
                  bench_dir=root / "benchmarks", device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


def mix(name: str, **kw) -> dict:
    out = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def appended(tmp_path_factory):
    """A checkout with one cell per driver added from new files alone: a
    configuration and a traffic mix of its own each, and entries appended
    to BENCHMARK.json."""
    sf = tiny("slowflow_1080q", TINY_SF)
    sf["checks"] = {"flow_epe_mean_px": 1e-4, "occ_mismatch_share": 1e-3}
    dt = tiny("tracking_1080q", TINY_DT)
    dt["checks"] = {"final_epe_mean_px": 1e-4,
                    "final_pixel_mismatch_share": 1e-3}
    return make_root(
        tmp_path_factory.mktemp("appended"),
        [dict(name="tiny_sf.b2", config="tiny_sf", traffic="tiny_jets",
              chips=1, why="a jet cell added by files alone",
              like="slowflow_1080q.b4"),
         dict(name="tiny_dt.f1", config="tiny_dt", traffic="tiny_finals",
              chips=1, why="a tracking cell added by files alone",
              like="tracking_1080q.f1")],
        {"tiny_sf": sf, "tiny_dt": dt},
        {"tiny_jets": mix("jets.b4", batch=2, pool_jets=4, check=3),
         "tiny_finals": mix("finals.f1", pool_finals=2)})


# ------------------------------------------------------------- the contract
def check_contract(spec: dict, root: Path) -> None:
    """The rules of the benchmark's contract that BENCHMARK.json and the
    files it names can show, in the checkout at `root`."""
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in spec["configs"]] \
        + [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (root / "benchmarks" / "metrics" / f"{m['name']}.py").exists(), \
            m["name"]
    for c in spec["configs"]:
        assert (root / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert (root / "benchmarks" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert "roofline" not in m["name"] or m["unit"] == "%"
    for w in spec["workloads"]:
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric, each per-layer metric's end-to-end one with it
        e2e = [m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per_layer = harness.cell_metrics(spec, w["name"], "per_layer")
        assert per_layer, w["name"]
        assert {m["moves"] for m in per_layer} <= set(e2e), w["name"]


@pytest.fixture(params=["committed", "appended"])
def checkout(request) -> Path:
    """The repo's own checkout, or one with a cell per driver appended."""
    if request.param == "committed":
        return REPO
    return request.getfixturevalue("appended")


def test_benchmark_json_keeps_the_contract(checkout):
    check_contract(harness.load_json(checkout / "BENCHMARK.json"), checkout)


def test_cells_in_the_order_they_matter(checkout):
    """The accepted cells come first, in their order; any cell may follow."""
    spec = harness.load_json(checkout / "BENCHMARK.json")
    names = [w["name"] for w in spec["workloads"]]
    assert names[:len(ACCEPTED)] == ACCEPTED


# ------------------------------------------------------------- discovery
def test_a_jet_cell_added_from_files_alone(appended, capsys):
    result, err = run_cell(appended, "tiny_sf.b2", capsys)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"jets_per_s", "batch_p90_ms",
                                      "setup_s"}
    for m in result["metrics"].values():
        assert UNIT.match(m["unit"]) and m["value"] > 0
    assert set(result["checks"]) == {"flow_epe_mean_px",
                                     "occ_mismatch_share"}
    lines = err.strip().splitlines()
    assert lines[-1].startswith("check occ_mismatch_share")
    assert lines[-2].startswith("check flow_epe_mean_px")


def test_a_tracking_cell_added_from_files_alone(appended, capsys):
    result, _ = run_cell(appended, "tiny_dt.f1", capsys)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"finals_per_s", "setup_s"}


def test_an_unknown_cell_is_refused(appended):
    with pytest.raises(SystemExit):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                 bench_dir=appended / "benchmarks", device="cpu")


def test_no_result_without_a_card(appended, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "tiny_sf.b2", "--seed", "1", "--seconds",
                   "1"], bench_dir=appended / "benchmarks")
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


# ------------------------------------------------------------- generators
@pytest.mark.parametrize("gen,config,traffic", [
    ("jets", tiny("slowflow_1080q", TINY_SF), mix("jets.b4", pool_jets=4)),
    ("finals", tiny("tracking_1080q", TINY_DT), mix("finals.f1",
                                                   pool_finals=2)),
])
def test_generator_repeats_for_a_seed_and_differs_between_two(gen, config,
                                                              traffic):
    make = harness.import_file(BENCH / "generators" / f"{gen}.py").make
    a = make(traffic, config, 2 ** 31 + 5, "cpu")
    b = make(traffic, config, 2 ** 31 + 5, "cpu")
    c = make(traffic, config, 2 ** 31 + 6, "cpu")
    assert torch.equal(a["frames"], b["frames"])
    assert not torch.equal(a["frames"], c["frames"])
    assert float(a["frames"].min()) >= 0 and float(a["frames"].max()) <= 255
    if gen == "jets":
        # the same speeds and directions for every seed, in another order
        for key in ("u", "v"):
            assert torch.equal(a[key], b[key])
        assert torch.allclose(torch.sort(torch.hypot(a["u"], a["v"]))[0],
                              torch.sort(torch.hypot(c["u"], c["v"]))[0])
    else:
        assert torch.equal(a["forward"], b["forward"])
        assert not torch.equal(a["forward"], c["forward"])
        assert torch.equal(a["draws"][1][(1, 0)][0], b["draws"][1][(1, 0)][0])


# ------------------------------------------------------------- readers
def reader(name):
    return harness.import_file(BENCH / "metrics" / f"{name}.py")


# a configuration whose two pyramid levels, (64, 320) and (57, 288), K2
# covers with grids of 10 x 4 and 9 x 4 blocks of 32 x 16
PROFILED_SF = dict(height=64, width=320, cfg=dict(slow_flow_layers="2"))
K2_NAME = "void (anonymous namespace)::warp_assemble_kernel<{}, true, false>"
LEVELS = {(57, 288): ((9, 4, 2), (32, 16, 1)),
          (64, 320): ((10, 4, 2), (32, 16, 1))}


def recorded_profile():
    """A small recorded profile of two jet-solve calls of 2 jets: the
    coarse level with 1 alternation top and 1 outer iteration, then the
    fine one with 1 top and 2 outer iterations."""
    ev, kernels = [], []
    t = 0
    k1 = "void (anonymous namespace)::solve_kernel<false, false>"
    for call in range(2):
        for level, kinds in (((57, 288), (2, 0)), ((64, 320), (2, 0, 0))):
            for mode in kinds:
                ev.append(("cudaGraphLaunch", False, t, t + 10))
                kernels.append((K2_NAME.format(mode), t + 20, t + 120)
                               + LEVELS[level])
                kernels.append((k1, t + 120, t + 320, (132, 1, 1),
                                (256, 1, 1)))
                t += 400
        ev.append(("cudaLaunchKernel", False, t, t + 5))
    ev += [(k[0], True, k[1], k[2]) for k in kernels]
    counts = dict(launches={"solve_step": 10, "warp_assemble": 10})
    # the window: the two traced calls, then two untraced ones of 2 us
    win = harness.Window()
    win.walls, win.units = [3e-6, 3e-6, 2e-6, 2e-6], [2, 2, 2, 2]
    return dict(events=ev, kernels=kernels, window_s=t / 1e9, calls=2,
                units=4, counts=counts, window=win,
                config=tiny("slowflow_1080q", PROFILED_SF), unit="jets")


def test_readers_of_a_recorded_jet_profile():
    rec = recorded_profile()
    assert reader("host_launch_calls_per_jet.sf").read(rec) == 12 / 4
    # 10 x 300 ns busy against 4 jets at the untraced 1 us a jet
    assert reader("device_idle_pct.sf").read(rec) == pytest.approx(25.0)
    kw = dict(smoothing=1, iterations=30, zero_init=True)
    k1 = 2 * (2 * work.k1_solve(2, 57, 288, **kw)["bound_s"]
              + 3 * work.k1_solve(2, 64, 320, **kw)["bound_s"])
    assert reader("k1_roofline.sf").read(rec) == pytest.approx(
        100 * k1 / (10 * 200e-9))
    kw = dict(rho=(1.0, 1.0), omega=(0.0, 2.0), zero_duv=True)
    k2 = 2 * sum(work.k2_warp_assemble(2, h, w, mode=m, **kw)["bound_s"]
                 for (h, w), modes in (((57, 288), ("occ_assembly",
                                                    "assembly")),
                                       ((64, 320), ("occ_assembly",
                                                    "assembly", "assembly")))
                 for m in modes)
    assert reader("k2_roofline.sf").read(rec) == pytest.approx(
        100 * k2 / (10 * 100e-9))
    # nothing traced: no share, not zero
    assert reader("k1_roofline.sf").read(dict(rec, kernels=None)) is None


@pytest.mark.parametrize("fault", ["launch_count", "dropped_k1", "dropped_k2",
                                   "no_launch_config", "unknown_level"])
def test_a_trace_that_does_not_account_for_the_calls_fails(fault):
    """A share of the wrong calls is no reading: the reader fails."""
    rec = recorded_profile()
    ev = rec["kernels"]
    if fault == "launch_count":
        rec["counts"]["launches"]["solve_step"] = 9
    elif fault in ("dropped_k1", "dropped_k2"):
        kernel = "solve_kernel" if fault == "dropped_k1" else "warp_assemble"
        drop = max(i for i, e in enumerate(ev) if kernel in e[0])
        rec["kernels"] = ev[:drop] + ev[drop + 1:]
    elif fault == "no_launch_config":
        rec["kernels"] = [e[:3] + ((), ()) for e in ev]
    else:
        rec["kernels"] = [e[:3] + ((11, 4, 2), (32, 16, 1))
                          if "warp_assemble" in e[0] else e for e in ev]
    for name in ("k1_roofline.sf", "k2_roofline.sf"):
        with pytest.raises(kernel_share.TraceMismatch):
            reader(name).read(rec)


def test_records_out_of_device_order_read_the_same_shares():
    """The profiler may stamp a graph-replayed K1 after the next K2 (two K1
    records then overlap, as read on the card): the shares do not depend
    on the records' order."""
    rec = recorded_profile()
    want = [reader(n).read(rec) for n in ("k1_roofline.sf", "k2_roofline.sf")]
    ev = list(rec["kernels"])
    k1 = [i for i, e in enumerate(ev) if "solve_kernel" in e[0]]
    late = ev[k1[0]]
    ev[k1[0]] = (late[0], ev[k1[1]][1] - 4, ev[k1[1]][1] - 4 + late[2]
                 - late[1]) + late[3:]
    ev.reverse()
    got = [reader(n).read(dict(rec, kernels=ev))
           for n in ("k1_roofline.sf", "k2_roofline.sf")]
    assert got == pytest.approx(want)


def test_kernel_launches_read_the_exported_trace_and_delete_it(tmp_path,
                                                             monkeypatch):
    """The launch configuration comes from the profiler's exported trace,
    written to a temporary file that is gone afterwards."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)

    class Prof:
        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": [
                {"cat": "kernel", "name": K2_NAME.format(2), "ts": 10.5,
                 "dur": 2.25, "args": {"grid": [10, 4, 2],
                                       "block": [32, 16, 1]}},
                {"cat": "cuda_runtime", "name": "cudaGraphLaunch",
                 "ts": 9.0, "dur": 1.0}]}))

    out = harness.kernel_launches(Prof())
    assert out == [(K2_NAME.format(2), 10500, 12750, (10, 4, 2),
                    (32, 16, 1))]
    assert list(tmp_path.iterdir()) == []


def test_levels_are_the_configurations_pyramid():
    assert work.pyramid(270, 480, 5, 0.9) == [
        (270, 480), (243, 432), (218, 388), (196, 349), (176, 314)]
    assert work.pyramid(64, 320, 2, 0.9) == list(LEVELS)[::-1]


def test_readers_of_a_recorded_tracking_profile():
    ev = [("dt.alternate", False, 0, 400_000_000),
          ("dt.alternate", False, 500_000_000, 700_000_000),
          ("some_kernel", True, 100, 100_000_100)]
    win = harness.Window()
    win.walls, win.units = [1.5, 1.5, 1.0], [1, 1, 1]
    rec = dict(events=ev, window_s=3.0, calls=2, units=2, unit="finals",
               window=win, counts=dict(phases={"dt.init_final": (3.0, 2)}))
    assert reader("alternate_s_per_final.dt").read(rec) == pytest.approx(0.3)
    assert reader("init_s_per_final.dt").read(rec) == pytest.approx(1.5)
    assert reader("device_idle_pct.dt").read(rec) == pytest.approx(95.0)
    # a host span mirrored onto the device's rows is no kernel
    mirrored = dict(rec, events=ev + [("dt.alternate", True, 0, 400_000_000)])
    assert reader("device_idle_pct.dt").read(mirrored) == pytest.approx(95.0)
    assert reader("device_idle_pct.sf").read(rec) is None
    assert reader("init_s_per_final.dt").read(dict(rec, counts={})) is None
    # no untraced call after the traced ones: no idle share
    assert reader("device_idle_pct.dt").read(dict(rec, calls=3)) is None


def test_the_profilers_teardown_is_no_part_of_the_window(monkeypatch):
    """Untraced calls follow the traced ones however long the profiler
    takes to stop, so the idle share has an untraced pace to read."""
    import time

    class SlowTrace:
        def __init__(self, cell):
            self.calls = None

        def start(self):
            pass

        def stop(self, calls, units):
            if self.calls is None:
                self.calls = calls
                time.sleep(0.3)

        def read(self):
            return dict(calls=self.calls)

    class Cell:
        def units(self, i):
            return 1

        def call(self, i):
            time.sleep(0.01)
            return i

    monkeypatch.setattr(harness, "Trace", SlowTrace)
    win = harness.run_window(Cell(), 0.1, trace_calls=2)
    assert win.trace == dict(calls=2)
    assert len(win.walls) > 4 and win.seconds < 0.25


def test_breakdown_names_device_ops_and_idle_gaps():
    rec = recorded_profile()
    out = harness.breakdown(rec["events"])
    assert out["device_ops"][0][0].startswith("void (anonymous namespace)"
                                              "::solve_kernel")
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10
    # nine gaps of 100 ns between the ten segments' kernels
    assert sum(s for _, s in out["idle_gaps"]) == pytest.approx(900e-9)


# ------------------------------------------------------------- yardstick
def test_work_pins_the_bounds_at_the_bench_shape():
    k1 = work.k1_solve(4, 270, 480, smoothing=1, iterations=30,
                       zero_init=True)
    k2 = work.k2_warp_assemble(4, 270, 480, rho=(1.0, 1.0),
                               omega=(0.0, 2.0), mode="assembly",
                               zero_duv=True)
    assert round(k1["bound_s"] * 1e3, 4) == 0.0083
    assert round(k2["bound_s"] * 1e3, 4) == 0.0236
    assert k1["bound_by"] == k2["bound_by"] == "operations"


# ------------------------------------------------- reference and correct
def sf_cell(config=None, traffic=None, seed=2 ** 31 + 3):
    driver = harness.import_file(BENCH / "drivers" / "jet_solve.py")
    config = config or tiny("slowflow_1080q", TINY_SF)
    traffic = traffic or mix("jets.b4", pool_jets=4, check=4)
    return driver, driver.Cell(config, traffic, seed, "cpu")


def window_of(cell, calls):
    win = harness.Window()
    for i in range(calls):
        win.outputs.append(cell.call(i))
        win.units.append(cell.units(i))
    return win


def test_jet_reference_matches_the_port_on_the_cpu():
    driver, cell = sf_cell()
    win = window_of(cell, 1)
    values = harness.check(cell, driver.compare, win, 7)
    assert all(v["value"] <= 1e-6 for v in values), values


def test_tracking_reference_matches_the_port_on_the_cpu():
    driver = harness.import_file(BENCH / "drivers" / "final_pairs.py")
    cell = driver.Cell(tiny("tracking_1080q", TINY_DT),
                       mix("finals.f1", pool_finals=2, check=1),
                       2 ** 31 + 9, "cpu")
    win = window_of(cell, 1)
    values = harness.check(cell, driver.compare, win, 3)
    assert all(v["value"] <= 1e-6 for v in values), values


# the control's test size: large enough that bfloat16 drifts as it does at
# the cells' size
CONTROL_SF = dict(height=64, width=96, cfg=dict(
    slow_flow_layers="3", slow_flow_niter_alter="4",
    slow_flow_niter_outer="4", slow_flow_niter_solver="30"))


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5])
def test_the_jet_control_is_not_correct(seed):
    """The reference in bfloat16 put in the program's place fails the
    configuration's limits."""
    driver, cell = sf_cell(tiny("slowflow_1080q", CONTROL_SF), seed=seed)
    low = cell.expected(range(4), torch.bfloat16)
    values = driver.compare(low, cell.expected(range(4)),
                            cell.config["checks"])
    assert any(v["value"] > v["limit"] for v in values), values


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5])
def test_the_tracking_control_is_not_correct(seed):
    driver = harness.import_file(BENCH / "drivers" / "final_pairs.py")
    cell = driver.Cell(tiny("tracking_1080q", TINY_DT),
                       mix("finals.f1", pool_finals=1), seed, "cpu")
    low = cell.expected([0], torch.bfloat16)
    values = driver.compare(low, cell.expected([0]), cell.config["checks"])
    assert any(v["value"] > v["limit"] for v in values), values


def broken_run(root, cell, capsys, patch):
    with patch:
        result, _ = run_cell(root, cell, capsys, seconds=0.1)
    return result


def test_a_solve_that_returns_its_state_unchanged_is_not_correct(appended,
                                                                  capsys):
    from slowflow_tpu_torch.variational import multiframe

    def unchanged(uu, vv, *args, **kw):
        zero = torch.zeros_like(uu)
        return zero, zero, torch.zeros((uu.shape[0], 2))

    result = broken_run(appended, "tiny_sf.b2", capsys,
                        mock.patch.object(multiframe, "solve_step", unchanged))
    assert result["correct"] is False


def test_a_flow_altered_where_it_is_produced_is_not_correct(appended, capsys):
    from slowflow_tpu_torch.variational import multiframe

    level = multiframe.compute_one_level

    def altered(*args, **kw):
        wx, wy, occ = level(*args, **kw)
        return wx + 0.01, wy, occ

    result = broken_run(appended, "tiny_sf.b2", capsys,
                        mock.patch.object(multiframe, "compute_one_level",
                                          altered))
    assert result["correct"] is False


def test_a_final_flow_altered_where_it_is_produced_is_not_correct(appended,
                                                                  capsys):
    from slowflow_tpu_torch.tracking import driver

    readback = driver._readback

    def altered(*args):
        flow, occ = readback(*args)
        return flow + 0.01, occ

    result = broken_run(appended, "tiny_dt.f1", capsys,
                        mock.patch.object(driver, "_readback", altered))
    assert result["correct"] is False


@pytest.mark.cuda
def test_a_tiny_jet_cell_on_the_card(tmp_path, capsys, card):
    """The harness on the card at a tiny size, traced, with the
    configuration's own limits (the kernels round otherwise than the
    reference, so the CPU cells' near-exact limits do not apply); two
    levels whose K2 grids differ, so the rooflines read each call's
    level from the trace."""
    root = make_root(
        tmp_path,
        [dict(name="tiny_sf.b2", config="tiny_sf", traffic="tiny_jets",
              chips=1, why="a tiny cell on the card",
              like="slowflow_1080q.b4")],
        {"tiny_sf": tiny("slowflow_1080q", dict(TINY_SF, height=64,
                                                width=320))},
        {"tiny_jets": mix("jets.b4", batch=2, pool_jets=4, check=3,
                          trace_calls=2)})
    rc = run.main(["--workload", "tiny_sf.b2", "--seed", "12", "--seconds",
                   "1", "--trace", "1"], bench_dir=root / "benchmarks",
                  device=card)
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True, err
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name in ("k1_roofline.sf", "k2_roofline.sf",
                 "host_launch_calls_per_jet.sf", "device_idle_pct.sf"):
        assert np.isfinite(result["metrics"][name]["value"]), name
