"""The port's end-to-end pipeline (`slowflow_tpu_torch.bench_pipeline`)
against the JAX package's `tools/bench_pipeline.py`, on the CPU:

- `make_sequence` writes the same PNG bytes as the tool's (4 frames at the
  tool's 270x480);
- `bg_mask` equals the tool's, and `sf_flow_err` / `dt_flow_err` give the
  tool's `sf_flow_err_px` / `dt_flow_err_px` (which it rounds to 3
  decimals) on seeded flows: the tool's `run_pipeline` runs with its CLIs
  replaced by stubs that write those flows;
- `run_pipeline(..., device="cpu")` at 48x64, 5 jets, 1 final, 2 levels,
  2 x 2 x 5 iterations drives the three port CLIs to the end and recovers
  the motion: quantile within 10 % of |(1.5, -0.8)| = 1.70 px/frame (as
  chip_smoke holds stage 1), `sf_flow_err_px` and `dt_flow_err_px` <= 0.25 px
  (the full-depth production run is held to 0.12 on the card; measured here:
  0.06 and 0.09), and `stage3_seeds` rerunning stage 3 on the tree with the
  pipeline's seed reproduces its `dt_flow_err_px`;
- without a GPU, `run_pipeline`'s default device raises.
"""
import importlib.util
import json
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu.io import write_flo as jax_write_flo
from slowflow_tpu_torch import bench_pipeline as bp
from slowflow_tpu_torch import stage3_seeds

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "tool_bench_pipeline", ROOT / "tools" / "bench_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_match_the_tool(tool):
    assert (bp.U, bp.V, bp.H, bp.W, bp.START) == \
        (tool.U, tool.V, tool.H, tool.W, tool.START)


def test_make_sequence_is_byte_equal(tool, tmp_path):
    tool.make_sequence(tmp_path / "tool", 4, seed=2)
    bp.make_sequence(tmp_path / "port", 4, seed=2)
    names = sorted(p.name for p in (tmp_path / "tool").iterdir())
    assert names == [f"frame_{f:04d}.png" for f in range(4)]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "tool" / name).read_bytes()


def _tool_bg_mask(tool):
    """The tool's `bg_mask`, a closure of its `run_pipeline` that uses no
    free variable: rebuilt from its code object."""
    code = next(c for c in tool.run_pipeline.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "bg_mask")
    assert not code.co_freevars
    return types.FunctionType(code, vars(tool))


def test_bg_mask_matches_the_tool(tool):
    tool_mask = _tool_bg_mask(tool)
    for lo, hi in ((2, 4), (2, 12), (40, 52)):
        np.testing.assert_array_equal(bp.bg_mask(lo, hi), tool_mask(lo, hi))


def _seeded_flows(rng):
    """Flows whose error varies from pixel to pixel and is large inside the
    disc's corridor, so the medians depend on the mask."""
    h, w, s = bp.H, bp.W, bp.STEPS
    sf = np.stack([np.full((h, w), s * bp.U), np.full((h, w), s * bp.V)], -1)
    sf += rng.normal(size=(h, w, 2)) * 0.1
    sf[~bp.bg_mask(2, 2 + s)] += 3.0
    dt = np.stack([np.full((h // 2, w // 2), bp.DT_JETS * s * bp.U / 2),
                   np.full((h // 2, w // 2), bp.DT_JETS * s * bp.V / 2)], -1)
    dt += rng.normal(size=dt.shape) * 0.2
    dt[~bp.bg_mask(2, 2 + bp.DT_JETS * s)[::2, ::2]] -= 4.0
    return sf.astype(np.float32), dt.astype(np.float32)


def test_errors_match_the_tool(tool, tmp_path, rng):
    sf, dt = _seeded_flows(rng)
    root = tmp_path / "run"

    def afr(argv):
        (root / "seq").mkdir(parents=True)
        (root / "seq" / "quantil.dat").write_text("1.7\n3.0\n")
        return 0

    def sf_main(argv):
        (root / "sf_out").mkdir()
        jax_write_flo(root / "sf_out" / "frame_0002.flo", sf)
        return 0

    def dt_main(argv):
        (root / "dt_out").mkdir()
        jax_write_flo(root / "dt_out" / "frame_0002.flo", dt)
        return 0

    with mock.patch.object(tool, "make_sequence"), \
            mock.patch("slowflow_tpu.cli.adaptive_fr.main", afr), \
            mock.patch("slowflow_tpu.cli.slow_flow.main", sf_main), \
            mock.patch("slowflow_tpu.cli.dense_tracking.main", dt_main):
        out = tool.run_pipeline(root, 10, 2)
    got_sf, got_dt = bp.sf_flow_err(sf), bp.dt_flow_err(dt)
    assert 0.05 < got_sf < 1 and 0.05 < got_dt < 1
    assert round(got_sf, 3) == out["sf_flow_err_px"]
    assert round(got_dt, 3) == out["dt_flow_err_px"]


def test_run_pipeline_on_the_cpu(tmp_path):
    out = bp.run_pipeline(tmp_path / "run", 5, 1, device="cpu", h=48, w=64,
                          levels=2, niter_alter=2, niter_outer=2,
                          niter_solver=5)
    tool_keys = {"pipeline_s", "pipeline_jets_per_sec",
                 "stage1_adaptive_fr_s", "stage2_slow_flow_s",
                 "stage2_solves", "stage2_solves_per_sec",
                 "stage3_dense_tracking_s", "stage3_finals",
                 "stage3_threads", "stage3_s_per_final", "jets", "quantil",
                 "sf_flow_err_px", "dt_flow_err_px", "seq_gen_s"}
    assert tool_keys <= set(out)
    assert (out["jets"], out["stage2_solves"], out["stage3_finals"]) == \
        (5, 10, 1)
    assert abs(out["quantil"] - np.hypot(bp.U, bp.V)) <= \
        0.10 * np.hypot(bp.U, bp.V)
    assert out["sf_flow_err_px"] <= 0.25
    assert out["dt_flow_err_px"] <= 0.25
    assert out["peak_memory_gib"] == dict.fromkeys(
        ("stage1_adaptive_fr", "stage2_slow_flow", "stage3_dense_tracking"))
    # -batch 4 over 5 jets: groups of 4 and 1 in each direction
    assert out["stage2_phases"]["sf.batch"][1] == 4
    assert out["stage2_phases"]["sf.init_wait"][1] == 4
    assert set(out["stage2_per_batch_s"]) == {"sf.batch", "sf.solve",
                                              "sf.init_wait"}
    assert (tmp_path / "run" / "dt_out" / "frame_0002.flo").exists()
    # stage 3 again on the tree with the pipeline's seed gives its error
    rec = tmp_path / "seeds.json"
    assert stage3_seeds.main([str(tmp_path / "run"), "--finals", "1",
                              "--seeds", "3", "--threads", "1", "--device",
                              "cpu", "--out", str(rec)]) == 0
    seeds = json.loads(rec.read_text())["seeds"]
    assert seeds["3"]["dt_flow_err_px"] == [out["dt_flow_err_px"]]


def test_run_pipeline_defaults_to_cuda(tmp_path):
    with mock.patch("torch.cuda.is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no GPU"):
        bp.run_pipeline(tmp_path / "run", 5, 1)
    assert not (tmp_path / "run").exists()
