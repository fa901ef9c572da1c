"""The port's stage-3 CLI (`slowflow_tpu_torch.cli.dense_tracking -device
cpu`) against the JAX package's on the same synthetic stage-2 tree: frames,
forward and `_back.flo` jets and a `config.cfg` with `slow_flow_S` /
`jet_fps` (tests/test_cli_dt_threads.py's dataset, 36x44, 3 finals of 2
jets), with the port's proposal draws replaced by JAX's own.

- `.flo` within 1e-3 px on >= 99 % of pixels, occlusion maps >= 99 % equal;
- `-threads 2 -batch_finals 2` equal to the serial run (atol 1e-4,
  occlusions equal), as tests/test_cli_dt_threads.py asserts for JAX;
- `-select` / `-resume` as tests/test_e2e.py::
  test_dense_tracking_select_and_resume;
- `result.info`: the six timing rows and the Variables / Factors rows;
- without a GPU the CLI raises unless given `-device cpu`.
"""
from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu.cli import dense_tracking as jcli
from slowflow_tpu_torch.cli import dense_tracking as cli
from slowflow_tpu_torch.io import read_flo, read_pbm
from slowflow_tpu_torch.tracking import driver
from test_cli_dt_threads import FINALS, JETS, U, V, _cfg, dataset  # noqa: F401
from test_torch_tracking import jax_draws, one_torch_thread  # noqa: F401

TIMING_ROWS = ("Warping took", "Median took", "Data term computation took",
               "Adding unary potentials took",
               "Adding pairwise potentials took",
               "Run discrete optimization took")


def _port(argv):
    with mock.patch.object(driver, "default_draws",
                           lambda seed, device: jax_draws(seed)):
        return cli.main(argv + ["-device", "cpu"])


def _finals(out):
    return [(read_flo(out / f"frame_{k * JETS:03d}.flo"),
             read_pbm(out / "occlusions" / f"frame_{k * JETS}.pbm"))
            for k in range(FINALS)]


@pytest.fixture(scope="module")
def runs(dataset):  # noqa: F811
    tmp, seq, est = dataset
    assert jcli.main([str(_cfg(tmp, seq, est, "jax_ref"))]) == 0
    assert _port([str(_cfg(tmp, seq, est, "port_serial"))]) == 0
    assert _port([str(_cfg(tmp, seq, est, "port_threaded")), "-threads", "2",
                  "-batch_finals", "2"]) == 0
    return tmp


def test_cli_matches_jax(runs):
    for (flow, occ), (flow_j, occ_j) in zip(_finals(runs / "port_serial"),
                                            _finals(runs / "jax_ref")):
        d = np.abs(flow - flow_j).max(-1)
        assert (d <= 1e-3).mean() >= 0.99, (d > 1e-3).mean()
        assert (occ == occ_j).mean() >= 0.99
        inner = flow[8:-8, 8:-8]
        err = np.hypot(inner[..., 0] - JETS * U, inner[..., 1] - JETS * V)
        assert err.mean() < 0.6
    assert (runs / "port_serial" / "frame_000_vis.png").exists()


def test_cli_threads_match_serial(runs):
    for (flow_t, occ_t), (flow_s, occ_s) in zip(
            _finals(runs / "port_threaded"), _finals(runs / "port_serial")):
        np.testing.assert_allclose(flow_t, flow_s, atol=1e-4)
        np.testing.assert_array_equal(occ_t, occ_s)


def test_result_info_rows(runs):
    mine = (runs / "port_serial" / "result.info").read_text().splitlines()
    theirs = (runs / "jax_ref" / "result.info").read_text().splitlines()
    for row in TIMING_ROWS:
        assert sum(ln.startswith(row) for ln in mine) == 1, row
    for key in ("\tVariables:", "\tFactors:"):
        assert [ln for ln in mine if ln.startswith(key)] == \
            [ln for ln in theirs if ln.startswith(key)]
    threaded = (runs / "port_threaded" / "result.info").read_text()
    row = [ln for ln in threaded.splitlines() if ln.startswith("\tVariables:")]
    assert row == [ln for ln in mine if ln.startswith("\tVariables:")]


def test_select_and_resume(dataset, capsys):  # noqa: F811
    tmp, seq, est = dataset
    cfg = str(_cfg(tmp, seq, est, "port_select"))
    assert _port([cfg, "-select", "1"]) == 0
    out = tmp / "port_select"
    assert (out / f"frame_{JETS:03d}.flo").exists()
    assert not (out / "frame_000.flo").exists()
    assert not (out / f"frame_{2 * JETS:03d}.flo").exists()
    mtime = (out / f"frame_{JETS:03d}.flo").stat().st_mtime_ns
    capsys.readouterr()
    assert _port([cfg, "-select", "1", "-resume", "-threads", "2"]) == 0
    assert "already exists" in capsys.readouterr().out
    assert (out / f"frame_{JETS:03d}.flo").stat().st_mtime_ns == mtime


def test_cli_helpers_match_jax():
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 2, (10, 14, 2)).astype(np.float32)
    np.testing.assert_allclose(cli._resize_flow_np(flow, 20, 28),
                               jcli._resize_flow_np(flow, 20, 28),
                               rtol=0, atol=2e-5 * np.abs(flow).max() * 2)
    assert cli._resize_flow_np(flow, 10, 14) is flow
    img = rng.normal(0, 1, (3, 12, 15)).astype(np.float32)
    avg, std = rng.random(3) * 100, rng.random(3) + 0.5
    for hbit in (False, True):
        got = cli.smoothness_weight(img, avg, std, hbit, "cpu")
        want = np.asarray(jcli.smoothness_weight(img, avg, std, hbit))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_cli_needs_a_gpu_by_default(dataset, monkeypatch):  # noqa: F811
    tmp, seq, est = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main([str(_cfg(tmp, seq, est, "port_nogpu"))])
    assert not (tmp / "port_nogpu" / "frame_000.flo").exists()
