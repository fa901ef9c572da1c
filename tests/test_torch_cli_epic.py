"""The port's EPIC-initialized CLIs against the JAX package's, on the CPU
(`-device cpu`).

- The stage-2 CLI with `deep_matching 1` on a 72x96 translating sequence
  (quantil.dat sets the matcher's radius to 8): its EPIC inits (the flows
  handed to the solve) agree with the JAX CLI's
  at the `epic_batched` tolerance (median |d| <= 1e-4 px, >= 99.9 % of
  pixels within 1e-3 px), and its `.flo` interior means are within 0.1 px
  of (+-u, +-v). The JAX CLI's solve is replaced by a stub: only its inits
  are compared.
- Pre-written `tmp/matches_*.dat` / `tmp/edges_*.dat` are used (the grid
  matcher is not called), as tests/test_ingestion.py shows for the JAX CLI.
- `max_flow` from quantil.dat's second line with `adaptive 0`: the
  matcher's radius equals the JAX CLI's.
- Stage 1 (`adaptive_fr`): quantil.dat within 1 % of the JAX CLI's, and in
  tests/test_e2e.py's range.
- `epicflow` with `auto` edges and matches: the .flo within the two-frame
  tolerance of the JAX CLI's (1 outer iteration, 1e-4 px).
- Without a GPU, the new entry points raise unless asked for the CPU.
"""
import contextlib
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu.cli import adaptive_fr as jadaptive
from slowflow_tpu.cli import epicflow as jepicflow
from slowflow_tpu.cli import slow_flow as jslow
from slowflow_tpu_torch.cli import adaptive_fr, epicflow, slow_flow
from slowflow_tpu_torch.io import (read_flo, write_edges, write_image,
                                   write_matches)

U, V = 1.0, 0.5


def _sequence(seq_dir, h=72, w=96, n=12, u=U, v=V, seed=7):
    """Smooth random texture translating at (u, v) px/frame (8-bit PNGs)."""
    rng = np.random.default_rng(seed)
    pad = 40
    base = rng.random((h + 2 * pad, w + 2 * pad, 3)) * 255
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    seq_dir.mkdir(parents=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for f in range(n):
        xs, ys = xx + pad - f * u, yy + pad - f * v
        x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
        fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
        img = (base[y0, x0] * (1 - fx) * (1 - fy)
               + base[y0, x0 + 1] * fx * (1 - fy)
               + base[y0 + 1, x0] * (1 - fx) * fy
               + base[y0 + 1, x0 + 1] * fx * fy)
        write_image(seq_dir / f"frame_{f:03d}.png", img)
    return seq_dir


def _cfg(path, seq_dir, out, extra=""):
    path.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{out}
    Jets\t2
    start\t2
    max_fps\t40
    ref_fps\t20
    jet_fps\t40
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t1
    slow_flow_S\t2
    slow_flow_layers\t2
    slow_flow_p_scale\t0.8
    slow_flow_occlusion_reasoning\t1
    slow_flow_niter_alter\t2
    slow_flow_niter_outer\t4
    slow_flow_niter_solver\t20
    """) + extra)
    return path


def _inits(calls):
    """(wx0, wy0) of every solve call, in call order, as numpy."""
    out = []
    for call in calls:
        wx0, wy0 = call.args[:2]
        out += [np.asarray(wx0.cpu() if isinstance(wx0, torch.Tensor)
                           else wx0),
                np.asarray(wy0.cpu() if isinstance(wy0, torch.Tensor)
                           else wy0)]
    return out


def _jax_solve_stub(wx0, wy0, windows, *args, **kwargs):
    return (np.zeros_like(np.asarray(wx0)),) * 2 \
        + (np.ones_like(np.asarray(wx0)),)


def test_stage2_epic_init_matches_jax(tmp_path):
    seq_dir = _sequence(tmp_path / "seq")
    (seq_dir / "quantil.dat").write_text("1.1\n2.0\n")
    cfg_t = _cfg(tmp_path / "t.cfg", seq_dir, tmp_path / "t_out")
    cfg_j = _cfg(tmp_path / "j.cfg", seq_dir, tmp_path / "j_out")
    with mock.patch.object(slow_flow, "variational_mt_batched",
                           wraps=slow_flow.variational_mt_batched) as solve:
        assert slow_flow.main([str(cfg_t), "-batch", "2",
                               "-device", "cpu"]) == 0
    with mock.patch.object(jslow, "variational_mt_batched",
                           side_effect=_jax_solve_stub) as jsolve:
        assert jslow.main([str(cfg_j), "-batch", "2"]) == 0
    mine, theirs = _inits(solve.call_args_list), _inits(jsolve.call_args_list)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        assert np.abs(a).max() > 0.3       # a real init, not zero flow
        d = np.abs(a - b)
        assert np.median(d) <= 1e-4 and (d <= 1e-3).mean() >= 0.999
    inner = (slice(12, -12), slice(12, -12))
    for name, sign in (("frame_002.flo", 1), ("frame_003.flo", 1),
                       ("frame_003_back.flo", -1)):
        flow = read_flo(tmp_path / "t_out" / name)[inner]
        assert abs(flow[..., 0].mean() - sign * U) <= 0.1, name
        assert abs(flow[..., 1].mean() - sign * V) <= 0.1, name


def test_stage2_ingests_edges_and_matches(tmp_path):
    """Ground-truth matches and uniform edges in tmp/ are used (the grid
    matcher must not run) and give an init near the true flow."""
    h, w = 56, 64
    seq_dir = _sequence(tmp_path / "seq", h=h, w=w, n=8)
    out = tmp_path / "out"
    cfg = _cfg(tmp_path / "sf.cfg", seq_dir, out,
               "slow_flow_layers\t1\nslow_flow_niter_outer\t3\n"
               "slow_flow_niter_solver\t15\n").read_text()
    cfg = cfg.replace("Jets\t2", "Jets\t1").replace("start\t2", "start\t3") \
        .replace("ref_fps\t20", "ref_fps\t40")
    (tmp_path / "sf.cfg").write_text(cfg)
    tmp = out / "tmp"
    tmp.mkdir(parents=True)
    for f in (3, 4):
        write_edges(tmp / f"edges_{f}.dat", np.full((h, w), 0.01, np.float32))
    ys, xs = np.mgrid[2:h - 2:5, 2:w - 2:5]
    pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    write_matches(tmp / "matches_3_4.dat",
                  np.concatenate([pts, pts + [U, V]], 1))
    write_matches(tmp / "matches_4_3.dat",
                  np.concatenate([pts, pts - [U, V]], 1))
    edges_read = mock.patch.object(slow_flow, "read_edges",
                                   wraps=slow_flow.read_edges)
    with mock.patch.object(slow_flow, "grid_matches_batched",
                           side_effect=AssertionError("matcher ran")), \
            edges_read as spy:
        assert slow_flow.main([str(tmp_path / "sf.cfg"), "-resume",
                               "-device", "cpu"]) == 0
    assert {str(c.args[0]).rsplit("/", 1)[-1] for c in spy.call_args_list} \
        == {"edges_3.dat", "edges_4.dat"}
    flow = read_flo(out / "frame_003.flo")[10:-10, 10:-10]
    err = np.hypot(flow[..., 0] - U, flow[..., 1] - V)
    assert err.mean() < 0.3, err.mean()


@pytest.mark.parametrize("quantil, s, radius",
                         [("0.7\n4.2\n", 2, 13), ("9\n30\n", 3, 64)],
                         ids=["radius-13", "halved"])
def test_stage2_matcher_radius_follows_quantil_dat(tmp_path, quantil, s,
                                                    radius):
    """adaptive 0: max_flow is 3x quantil.dat's second line times the jet's
    frame distance (12.6 px; 180 px, halved above 150 to 90, radius capped
    at 64); the matcher's radius is the JAX CLI's."""
    seq_dir = _sequence(tmp_path / "seq", h=40, w=48, n=10)
    (seq_dir / "quantil.dat").write_text(quantil)
    radii = {}
    for name, mod in (("port", slow_flow), ("jax", jslow)):
        cfg = _cfg(tmp_path / f"{name}.cfg", seq_dir, tmp_path / name,
                   f"slow_flow_S\t{s}\nslow_flow_layers\t1\n"
                   "slow_flow_niter_alter\t1\nslow_flow_niter_outer\t1\n"
                   "slow_flow_niter_solver\t2\n")
        seen = []

        def matcher(im1s, im2s, *args, radius=32, **kw):
            seen.append(radius)
            return [np.zeros((0, 4), np.float32)] * len(im1s)

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                mod, "grid_matches_batched", side_effect=matcher))
            argv = [str(cfg), "-batch", "2"]
            if mod is jslow:
                stack.enter_context(mock.patch.object(
                    mod, "variational_mt_batched",
                    side_effect=_jax_solve_stub))
            else:
                argv += ["-device", "cpu"]
            assert mod.main(argv) == 0
        radii[name] = set(seen)
    assert radii["port"] == radii["jax"] == {radius}


def test_adaptive_fr_matches_jax(tmp_path):
    for name in ("t", "j"):
        _sequence(tmp_path / name / "seq")
    argv = ["-folder", "seq", "-format", "frame_%03i.png", "-scale", "0.5",
            "-skip", "2", "-samples", "2", "-step", "2", "-start", "0"]
    assert adaptive_fr.main(["-path", str(tmp_path / "t"), *argv,
                             "-device", "cpu"]) == 0
    assert jadaptive.main(["-path", str(tmp_path / "j"), *argv]) == 0
    mine = [float(x) for x in
            (tmp_path / "t" / "seq" / "quantil.dat").read_text().split()]
    theirs = [float(x) for x in
              (tmp_path / "j" / "seq" / "quantil.dat").read_text().split()]
    assert len(mine) == len(theirs) == 2
    assert abs(mine[0] - theirs[0]) <= 0.01 * theirs[0]
    assert 0.4 < mine[0] < 2.5
    info = (tmp_path / "t" / "seq" / "adaptiveFR" / "results.info")
    assert "0.9 quantil" in info.read_text()


def test_quantile_convention_matches_jax():
    rng = np.random.default_rng(8)
    for n in (7, 10, 40):
        flows = [rng.normal(0, 2, (n, 3, 2)) for _ in range(2)]
        for q in (0.5, 0.9, 0.95):
            assert adaptive_fr.quantile_of_magnitudes(flows, q) == \
                jadaptive.quantile_of_magnitudes(flows, q)


def test_epicflow_auto_matches_jax(tmp_path):
    seq_dir = _sequence(tmp_path / "seq", n=3)
    args = [str(seq_dir / "frame_000.png"), str(seq_dir / "frame_001.png"),
            "auto", "auto"]
    flags = ["-sintel", "-i", "1"]
    assert epicflow.main([*args, str(tmp_path / "t.flo"), *flags,
                          "-device", "cpu"]) == 0
    assert jepicflow.main([*args, str(tmp_path / "j.flo"), *flags]) == 0
    mine, theirs = read_flo(tmp_path / "t.flo"), read_flo(tmp_path / "j.flo")
    assert np.abs(mine - theirs).max() <= 1e-4
    inner = mine[12:-12, 12:-12]
    assert abs(np.median(inner[..., 0]) - U) < 0.1
    assert abs(np.median(inner[..., 1]) - V) < 0.1


@pytest.fixture
def no_gpu():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        yield


def test_new_entry_points_raise_without_gpu(no_gpu, tmp_path):
    seq_dir = _sequence(tmp_path / "seq", h=24, w=32, n=3)
    with pytest.raises(RuntimeError, match="no GPU"):
        adaptive_fr.main(["-path", str(tmp_path), "-folder", "seq",
                          "-format", "frame_%03i.png", "-samples", "1"])
    with pytest.raises(RuntimeError, match="no GPU"):
        epicflow.main([str(seq_dir / "frame_000.png"),
                       str(seq_dir / "frame_001.png"), "auto", "auto",
                       str(tmp_path / "o.flo")])
    cfg = _cfg(tmp_path / "sf.cfg", seq_dir, tmp_path / "out")
    with pytest.raises(RuntimeError, match="no GPU"):
        slow_flow.main([str(cfg)])
    assert not (tmp_path / "o.flo").exists()
