"""The published default input path through both stage-2 CLIs, on the CPU:
16-bit raw Bayer PNGs (`16bit 1`, `raw 1`, `raw_red_loc 1,0`, each of the
three `raw_demosaicing` modes), `scale 0.5`, occlusion reasoning on, zero
init (`deep_matching 0`, as in cfgs/slow_flow.cfg), at 64x80. The JAX CLI
runs its XLA route (`slow_flow_warp_mode banded`, `slow_flow_fused_data
0`); the port's CLI (`-device cpu`) reads the same cfg. Every `.flo` the
port writes is within 1e-5 px of the JAX CLI's, and the occlusion maps are
the same files.
"""
import textwrap

import numpy as np
import pytest

from slowflow_tpu.cli import slow_flow as jslow
from slowflow_tpu_torch.cli import slow_flow
from slowflow_tpu_torch.io import read_flo, write_image
from test_e2e_raw import RED_X, RED_Y, mosaic
from test_torch_tracking import one_torch_thread  # noqa: F401

U, V = 1.0, 0.5
H, W = 64, 80
FLO_TOL = 1e-5      # px


def _bayer_sequence(seq_dir, n=14, seed=9):
    rng = np.random.default_rng(seed)
    pad = 30
    base = rng.random((H + 2 * pad, W + 2 * pad, 3)) * 255
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    seq_dir.mkdir(parents=True)
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(n):
        xs, ys = xx + pad - f * U, yy + pad - f * V
        x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
        fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
        img = (base[y0, x0] * (1 - fx) * (1 - fy)
               + base[y0, x0 + 1] * fx * (1 - fy)
               + base[y0 + 1, x0] * (1 - fx) * fy
               + base[y0 + 1, x0 + 1] * fx * fy)
        write_image(seq_dir / f"frame_{f:03d}.png", mosaic(img) * 256.0,
                    bit16=True)
    return seq_dir


def _cfg(path, seq_dir, out, mode):
    path.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{out}
    Jets\t2
    start\t4
    max_fps\t40
    ref_fps\t20
    jet_fps\t40
    adaptive\t0
    16bit\t1
    raw\t1
    raw_demosaicing\t{mode}
    raw_red_loc\t{RED_X},{RED_Y}
    scale\t0.5
    deep_matching\t0
    slow_flow_S\t3
    slow_flow_rho_0\t1
    slow_flow_rho_1\t1
    slow_flow_omega_0\t0
    slow_flow_omega_1\t2
    slow_flow_layers\t2
    slow_flow_p_scale\t0.9
    slow_flow_occlusion_reasoning\t1
    slow_flow_output_occlusions\t1
    slow_flow_niter_alter\t2
    slow_flow_niter_outer\t2
    slow_flow_niter_solver\t10
    slow_flow_warp_mode\tbanded
    slow_flow_fused_data\t0
    """))
    return path


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_raw_bayer_default_path_matches_jax(tmp_path, mode):
    seq_dir = _bayer_sequence(tmp_path / "seq")
    cfg_j = _cfg(tmp_path / "j.cfg", seq_dir, tmp_path / "j_out", mode)
    cfg_t = _cfg(tmp_path / "t.cfg", seq_dir, tmp_path / "t_out", mode)
    assert jslow.main([str(cfg_j), "-batch", "2"]) == 0
    assert slow_flow.main([str(cfg_t), "-batch", "2", "-device", "cpu"]) == 0
    flos = sorted(p.relative_to(tmp_path / "j_out")
                  for p in (tmp_path / "j_out").rglob("*.flo"))
    assert flos
    for rel in flos:
        want, got = read_flo(tmp_path / "j_out" / rel), \
            read_flo(tmp_path / "t_out" / rel)
        assert got.shape == want.shape == (H // 2, W // 2, 2)
        assert np.abs(got - want).max() <= FLO_TOL, rel
    pbms = sorted(p.relative_to(tmp_path / "j_out")
                  for p in (tmp_path / "j_out").rglob("*.pbm"))
    assert pbms
    for rel in pbms:
        assert (tmp_path / "t_out" / rel).read_bytes() == \
            (tmp_path / "j_out" / rel).read_bytes(), rel
