"""The port stands alone: no module of slowflow_tpu_torch, and not
chip_smoke.py, imports the JAX package, the JAX benchmark or jax; and the
port's own copies of the JAX package's jax-free helpers (cfg parsing, .flo /
image / PBM I/O, demosaicing, colour wheel, EPE, frame naming, the bench
scene) agree with the originals on the same inputs."""
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
        import slowflow_tpu_torch.bench_scene
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
