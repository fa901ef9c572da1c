"""The port stands alone: no module of slowflow_tpu_torch, and not
chip_smoke.py, imports the JAX package, the JAX benchmark or jax; and the
port's own copies of the JAX package's jax-free helpers (cfg parsing, .flo /
image / PBM / edge-map / match-file I/O, demosaicing, colour wheel, EPE,
frame naming, the phase timers, the bench scenes, the seed-graph
Dijkstra's C++ source, small-segment removal) agree with the originals on
the same inputs."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "slowflow_tpu_torch"
FORBIDDEN = ("slowflow_tpu", "bench", "jax")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_the_jax_package(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for line, name in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_cli_import_leaves_the_jax_package_out():
    code = textwrap.dedent("""
        import sys
        import slowflow_tpu_torch.cli.slow_flow
        import slowflow_tpu_torch.cli.adaptive_fr
        import slowflow_tpu_torch.cli.epicflow
        import slowflow_tpu_torch.cli.dense_tracking
        import slowflow_tpu_torch.tracking
        import slowflow_tpu_torch.bench_scene
        import slowflow_tpu_torch.epic
        import slowflow_tpu_torch.native
        import slowflow_tpu_torch.variational.twoframe
        import slowflow_tpu_torch.bench_pipeline
        import slowflow_tpu_torch.parallel.mesh
        import slowflow_tpu_torch.utils.tracing
        import slowflow_tpu_torch.variational.graphs
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("slowflow_tpu", "bench", "jax")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cfg", sorted((ROOT / "cfgs").glob("*.cfg")),
                         ids=lambda p: p.name)
def test_parameter_list_parses_cfgs_alike(cfg):
    from slowflow_tpu.config import ParameterList as JaxParameterList
    from slowflow_tpu_torch.config import ParameterList, Verbosity

    mine, theirs = ParameterList(), JaxParameterList()
    mine.read(str(cfg))
    theirs.read(str(cfg))
    assert vars(mine) == vars(theirs)
    assert mine.cfg_string() == theirs.cfg_string()
    assert mine.verbosity(Verbosity.WRITE_FILES) == \
        theirs.verbosity(Verbosity.WRITE_FILES)


def test_flo_round_trips_are_bit_equal(tmp_path):
    from slowflow_tpu.io import read_flo as jax_read, write_flo as jax_write
    from slowflow_tpu_torch.io import read_flo, write_flo

    flow = np.random.default_rng(0).normal(0, 3, (13, 17, 2)).astype(
        np.float32)
    write_flo(tmp_path / "a.flo", flow)
    jax_write(tmp_path / "b.flo", flow)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    np.testing.assert_array_equal(read_flo(tmp_path / "b.flo"), flow)
    np.testing.assert_array_equal(jax_read(tmp_path / "a.flo"), flow)


def test_image_and_pbm_round_trips_are_bit_equal(tmp_path):
    from slowflow_tpu.io import images as jax_images
    from slowflow_tpu_torch.io import (read_image, read_pbm, write_image,
                                       write_pbm)

    rng = np.random.default_rng(1)
    mask = (rng.random((11, 19)) * 255).astype(np.uint8)
    write_pbm(tmp_path / "a.pbm", mask)
    jax_images.write_pbm(tmp_path / "b.pbm", mask)
    assert (tmp_path / "a.pbm").read_bytes() == (tmp_path / "b.pbm").read_bytes()
    np.testing.assert_array_equal(read_pbm(tmp_path / "a.pbm"),
                                  jax_images.read_pbm(tmp_path / "a.pbm"))
    np.testing.assert_array_equal(read_pbm(tmp_path / "a.pbm"),
                                  np.where(mask >= 128, 255, 0))
    for bit16, img in ((False, rng.random((9, 14, 3)) * 255),
                       (True, rng.random((9, 14)) * 65535)):
        write_image(tmp_path / "a.png", img, bit16=bit16)
        jax_images.write_image(tmp_path / "b.png", img, bit16=bit16)
        np.testing.assert_array_equal(read_image(tmp_path / "a.png"),
                                      jax_images.read_image(tmp_path / "b.png"))


def test_edge_and_match_files_round_trip_bit_equal(tmp_path):
    from slowflow_tpu.io import edges as jax_edges
    from slowflow_tpu.io import matches as jax_matches
    from slowflow_tpu_torch.io import (read_edges, read_matches, write_edges,
                                       write_matches)

    rng = np.random.default_rng(4)
    edges = rng.random((13, 17)).astype(np.float32)
    write_edges(tmp_path / "a.dat", edges)
    jax_edges.write_edges(tmp_path / "b.dat", edges)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    np.testing.assert_array_equal(read_edges(tmp_path / "b.dat", 17, 13),
                                  jax_edges.read_edges(tmp_path / "a.dat", 17,
                                                       13))
    with pytest.raises(ValueError):
        read_edges(tmp_path / "a.dat", 18, 13)
    matches = np.concatenate([rng.integers(0, 90, (20, 2)),
                              rng.normal(40, 20, (20, 2))], 1)
    write_matches(tmp_path / "a.txt", matches)
    jax_matches.write_matches(tmp_path / "b.txt", matches)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    with open(tmp_path / "a.txt", "a") as fh:
        fh.write("1 2 3\nnot a match line\n5 6 7 8 0.9 12\n")
    np.testing.assert_array_equal(read_matches(tmp_path / "a.txt"),
                                  jax_matches.read_matches(tmp_path / "a.txt"))
    (tmp_path / "empty.txt").write_text("")
    assert read_matches(tmp_path / "empty.txt").shape == (0, 4)


def test_geodesic_source_is_the_jax_packages():
    assert (PORT / "native" / "geodesic.cpp").read_bytes() == \
        (ROOT / "slowflow_tpu" / "native" / "geodesic.cpp").read_bytes()


def test_phase_reports_agree(monkeypatch, capsys):
    from slowflow_tpu.utils import phases as jax_phases
    from slowflow_tpu_torch.utils import phases

    outs = []
    for mod in (phases, jax_phases):
        monkeypatch.setattr(mod, "ENABLED", True)
        mod.report()                      # start from empty accumulators
        capsys.readouterr()
        for name, sec in (("sf.solve", 1.25), ("sf.matches", 0.5),
                          ("sf.solve", 0.75)):
            mod.add(name, sec)
        with mod.phase("epic.dt_device"):
            pass
        mod.report()
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if "epic.dt_device" not in ln and "TOTAL" not in ln])
    assert outs[0] == outs[1]
    assert any("sf.solve" in ln and "x2" in ln for ln in outs[0])


def test_demosaic_agrees_on_a_seeded_bayer_frame():
    from slowflow_tpu.utils import demosaic as jax_demosaic
    from slowflow_tpu_torch.utils import demosaic

    bayer = (np.random.default_rng(2).random((24, 30)) * 4095).astype(
        np.float32)
    for red in ((0, 0), (1, 0), (0, 1), (1, 1)):
        for fn in ("bayer2rgb", "bayer2rgb_green_ratio",
                   "bayer2rgb_hamilton_adams"):
            np.testing.assert_array_equal(
                getattr(demosaic, fn)(bayer, *red),
                getattr(jax_demosaic, fn)(bayer, *red))
        np.testing.assert_array_equal(
            demosaic.raw_weighting(24, 30, *red, 0.7),
            jax_demosaic.raw_weighting(24, 30, *red, 0.7))


def test_colorwheel_and_epe_agree():
    from slowflow_tpu.utils import colorwheel as jax_colorwheel
    from slowflow_tpu.utils import metrics as jax_metrics
    from slowflow_tpu_torch.utils import colorwheel, metrics

    rng = np.random.default_rng(3)
    u, v = rng.normal(0, 2, (2, 15, 21))
    u[0, 0] = np.nan
    np.testing.assert_array_equal(colorwheel.flow_color_img(u, v),
                                  jax_colorwheel.flow_color_img(u, v))
    flow, gt = rng.normal(0, 2, (2, 15, 21, 2))
    gt[3, 4, 0] = 1e10
    mask = rng.random((15, 21)) > 0.3
    for m in (None, mask):
        assert metrics.compute_epe(flow, gt, m) == \
            jax_metrics.compute_epe(flow, gt, m)


def test_frame_naming_and_output_dirs_agree(tmp_path):
    from slowflow_tpu.cli import common as jax_common
    from slowflow_tpu_torch.cli import common

    for start, offset in ((1000, -3), (2040, 5), (7, 2)):
        assert common.frame_path("seq", "frame_%04i.png", start, offset,
                                 False) == \
            jax_common.frame_path("seq", "frame_%04i.png", start, offset,
                                  False)
        assert common.frame_path("seq", "f_%04d_%02d.png", start, offset,
                                 True) == \
            jax_common.frame_path("seq", "f_%04d_%02d.png", start, offset,
                                  True)
    (tmp_path / "out").mkdir()
    (tmp_path / "out_1").mkdir()
    for resume, overwrite in ((False, False), (True, False), (False, True)):
        assert common.unique_output_dir(str(tmp_path / "out"), resume,
                                        overwrite) == \
            jax_common.unique_output_dir(str(tmp_path / "out"), resume,
                                         overwrite)


def test_bench_scene_matches_the_jax_benchmark():
    sys.path.insert(0, str(ROOT))
    from bench import _moving_sequence
    from slowflow_tpu_torch.bench_scene import moving_sequence

    for seed in (0, 1):
        np.testing.assert_array_equal(
            moving_sequence(5, 27, 31, 1.7, -0.8, seed=seed),
            _moving_sequence(5, 27, 31, 1.7, -0.8, seed=seed))


def test_remove_small_segments_is_bit_equal():
    from slowflow_tpu.utils.segments import remove_small_segments as jax_rss
    from slowflow_tpu_torch.utils.segments import remove_small_segments

    rng = np.random.default_rng(6)
    binary = (rng.random((30, 40)) > 0.3).astype(np.int32)
    labels = rng.integers(-2, 3, (30, 40)).astype(np.float32)
    # exact per-value branch (threshold below the value gap), then the
    # quantized-similarity branch
    for F, thr, size in ((binary, 0.1, 5), (labels, 0.5, 4),
                         (labels, 1.5, 6), (labels * 0.37, 0.2, 3)):
        mine, theirs = F.copy(), F.copy()
        np.testing.assert_array_equal(remove_small_segments(mine, thr, size),
                                      jax_rss(theirs, thr, size))
        np.testing.assert_array_equal(mine, theirs)
        assert (mine != F).any()


def test_stage3_bench_scene_matches_the_jax_benchmark():
    """bench.py's dt_final_pair_seconds (its scene, inputs and
    configuration, lines 181-209) with its tracker replaced by a recorder,
    against the port's stage3_final_pair / stage3_config."""
    import dataclasses
    from unittest import mock

    sys.path.insert(0, str(ROOT))
    import bench
    from slowflow_tpu.tracking import driver as jax_driver
    from slowflow_tpu_torch.bench_scene import (stage3_config,
                                                stage3_final_pair)

    h, w, jets = 40, 48, 3
    calls = []

    def recorder(cfg, rate_flows, fwd, bwd, occ, data, ddx, ddy, sw,
                 epic_ctx=None):
        calls.append(dict(cfg=cfg, rate_flows=rate_flows, forward=fwd,
                          backward=bwd, occlusions=occ, data=data,
                          data_dx=ddx, data_dy=ddy, smooth_weight=sw,
                          epic_ctx=epic_ctx))
        return np.zeros((h // 2, w // 2, 2), np.float32), None, {}

    with mock.patch.object(jax_driver, "track_final_pair", recorder):
        bench.dt_final_pair_seconds(h=h, w=w, jets=jets, seed=1)
    want = calls[-1]
    job, gt = stage3_final_pair(h, w, jets, seed=1, device="cpu")
    assert dataclasses.asdict(stage3_config(jets=jets)) == \
        dataclasses.asdict(want["cfg"])
    for k in ("forward", "backward", "data", "smooth_weight"):
        np.testing.assert_array_equal(job[k], want[k])
    np.testing.assert_array_equal(job["rate_flows"][0][0],
                                  want["rate_flows"][0][0])
    assert job["occlusions"] is None and want["occlusions"] is None
    for k in ("data_dx", "data_dy"):
        np.testing.assert_allclose(job[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max())
    for mine, theirs in zip(job["epic_ctx"][:2], want["epic_ctx"][:2]):
        np.testing.assert_allclose(mine, theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max())
    assert job["epic_ctx"][2].__dict__ == want["epic_ctx"][2].__dict__
    np.testing.assert_array_equal(gt, want["forward"].sum(0)[::2, ::2, 0] / 2)
