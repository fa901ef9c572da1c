"""The port's stage-2 jet solve end to end against the JAX package.

`variational_mt_batched` of slowflow_tpu_torch (CPU tensors, so the kernels'
plain twins) and of slowflow_tpu (XLA route: banded warp mode, unfused
assembly, composed solve) get the same numpy inputs. The port runs each of
its routes (ROUTES): the merged route with the fused-occlusion control flow,
where the JAX XLA route assembles the first outer iteration from gated
masks instead (the same sums in real arithmetic), the stack route with the
composed solve, and the unfused route with the pallas_warp window warp.

At these tiny sizes the production energy (Charbonnier penalties with
eps = 0.001, 10 SOR sweeps) amplifies float32 rounding: a 1e-7 relative
perturbation of the input moves the JAX package's own flow by several px at
a few pixels after 2 alternations x 3 outer iterations. Short runs are held
to the JAX flow at 1e-4 px; the full slice is held to the spread JAX shows
against itself under that perturbation (ROADMAP Queue 3).
"""
import contextlib
import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slowflow_tpu.variational import multiframe as jmf
from slowflow_tpu_torch.variational import multiframe as tmf
from slowflow_tpu_torch.variational.params import from_jax_params


def _scene(b, s, h, w, seed=0):
    """Smooth texture translating by a per-jet (u, v) with a counter-moving
    disc, so the occlusion step has real occlusion boundaries."""
    rng = np.random.default_rng(seed)
    f = 2 * (s - 1) + 1
    pad = 12
    yy, xx = np.mgrid[0:h, 0:w]
    seqs = []
    for j in range(b):
        base = rng.random((h + 2 * pad, w + 2 * pad)) * 255
        for _ in range(2):
            base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                           + np.roll(base, 1, 1) + np.roll(base, -1, 1))
        u, v = 0.8 + 0.3 * j, -0.5
        frames = []
        for k in range(-(s - 1), s):
            xs = np.clip(xx + pad - k * u, 0, w + 2 * pad - 2)
            ys = np.clip(yy + pad - k * v, 0, h + 2 * pad - 2)
            x0, y0 = xs.astype(int), ys.astype(int)
            fx, fy = xs - x0, ys - y0
            im = (base[y0, x0] * (1 - fx) * (1 - fy)
                  + base[y0, x0 + 1] * fx * (1 - fy)
                  + base[y0 + 1, x0] * (1 - fx) * fy
                  + base[y0 + 1, x0 + 1] * fx * fy)
            disc = (yy - h / 2) ** 2 + (xx - w / 2 + k * u) ** 2 < (h / 5) ** 2
            im = np.where(disc, 255.0 - im, im)
            frames.append(np.repeat(im[None], 3, 0))
        seqs.append(np.stack(frames))
    seq = np.stack(seqs).astype(np.float32)
    seq = (seq - seq.mean()) / (seq.std() / 255.0)
    return seq


# the port's routes, as overrides of the JAX XLA-route parameters
ROUTES = {
    "merged": dict(fused_data=True, warp_mode="shift"),
    "stack": dict(fused_data=True, merge_warp=False, fused_solve=False),
    "unfused": dict(pallas_warp=True, fused_solve=False),
}
ROUTE_OF = {"merged": ("merged", "fused"), "stack": ("stack", "composed"),
            "unfused": ("unfused", "composed")}


def _port_params(jp, route):
    p = dataclasses.replace(from_jax_params(jp), **ROUTES[route])
    assert (p.route().assembly, p.route().solve) == ROUTE_OF[route]
    return p


def _run_both(jp, b, h, w, seed=0, route="merged"):
    seq = _scene(b, jp.S, h, w, seed)
    z = np.zeros((b, h, w), np.float32)
    jwx, jwy, jocc = (np.asarray(o) for o in
                      jmf.variational_mt_batched(z, z, seq, jp))
    twx, twy, tocc = (o.numpy() for o in tmf.variational_mt_batched(
        z, z, seq, _port_params(jp, route), device="cpu"))
    return (jwx, jwy, jocc), (twx, twy, tocc)


SLICE = jmf.MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0,
                             rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                             p_scale=0.9, niter_alter=2, niter_outer=3,
                             niter_solver=10, occlusion_reasoning=True,
                             smoothing=1, warp_mode="banded",
                             fused_data=False)


def _quantiles(d):
    return np.quantile(d, [0.5, 0.9]), float(d.mean())


def test_slice_matches_jax():
    """B=2, S=3, 36x40, 2 levels, 2 alternations x 3 outer x 10 SOR sweeps,
    occlusion reasoning on, the port on its merged route. Bound: the port is
    as close to JAX as JAX is to itself under a 1e-7 relative input
    perturbation (x3, plus 1e-4 px)."""
    _check_slice("merged")


@pytest.mark.parametrize("route", ["stack", "unfused"])
def test_slice_matches_jax_on_route(route):
    """test_slice_matches_jax on the port's other routes, same bounds."""
    _check_slice(route)


def _check_slice(route):
    seq = _scene(2, 3, 36, 40)
    z = np.zeros((2, 36, 40), np.float32)
    rng = np.random.default_rng(99)
    noisy = (seq * (1 + 1e-7 * rng.standard_normal(seq.shape))
             ).astype(np.float32)
    jwx, jwy, jocc = (np.asarray(o) for o in
                      jmf.variational_mt_batched(z, z, seq, SLICE))
    nwx, nwy, nocc = (np.asarray(o) for o in
                      jmf.variational_mt_batched(z, z, noisy, SLICE))
    twx, twy, tocc = (o.numpy() for o in tmf.variational_mt_batched(
        z, z, seq, _port_params(SLICE, route), device="cpu"))
    assert np.isfinite(twx).all() and np.isfinite(twy).all()
    assert set(np.unique(tocc)) <= {-1.0, 1.0}
    (q50, q90), mean = _quantiles(np.hypot(twx - jwx, twy - jwy))
    (s50, s90), smean = _quantiles(np.hypot(nwx - jwx, nwy - jwy))
    assert q50 <= 3 * s50 + 1e-4 and q90 <= 3 * s90 + 1e-4
    assert mean <= 3 * smean + 1e-4
    assert (tocc != jocc).mean() <= 3 * (nocc != jocc).mean() + 0.005


SHORT_RUNS = [
    {"layers": 2, "niter_alter": 1, "niter_outer": 1},
    {"niter_alter": 1, "niter_outer": 1, "niter_inner": 2, "smoothing": 0},
    {"niter_alter": 2, "niter_outer": 1, "occlusion_reasoning": False,
     "smoothing": 2},
    {"niter_alter": 2, "niter_outer": 1, "one_direction": True},
]


@pytest.mark.parametrize("route,change", [
    pytest.param(route, change,
                 id=(f"change{i}" if route == "merged"
                     else f"{route}-change{i}"))
    for route in ROUTES for i, change in enumerate(SHORT_RUNS)])
def test_short_runs_match_jax(route, change):
    """Short runs stay in the well-conditioned regime: 1e-4 px, on every
    port route."""
    jp = jmf.MultiFrameParams(**{**SLICE.__dict__, "layers": 1, **change})
    h, w = (36, 40) if jp.layers == 2 else (24, 32)
    (jwx, jwy, jocc), (twx, twy, tocc) = _run_both(jp, 2, h, w, seed=1,
                                                   route=route)
    assert np.abs(twx - jwx).max() <= 1e-4
    assert np.abs(twy - jwy).max() <= 1e-4
    np.testing.assert_array_equal(tocc, jocc)


def test_single_window_entry_matches_batched():
    p = from_jax_params(SLICE)
    seq = _scene(1, 3, 24, 32, seed=2)
    z = np.zeros((1, 24, 32), np.float32)
    one = tmf.variational_mt(z[0], z[0], seq[0], p, device="cpu")
    many = tmf.variational_mt_batched(z, z, seq, p, device="cpu")
    for a, b in zip(one, many):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    p = from_jax_params(SLICE)
    seq = _scene(1, 3, 16, 16)
    z = np.zeros((1, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="no GPU"):
        tmf.variational_mt_batched(z, z, seq, p, device="cuda")
    from slowflow_tpu_torch.runtime import resolve_device
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    from slowflow_tpu_torch.variational.fused_warp import warp_assemble
    meta = torch.empty((1, 5, 3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        warp_assemble(meta, *[torch.empty((1, 8, 8), device="meta")] * 5,
                      torch.empty((1, 3, 8, 8), device="meta"), p)


def test_import_leaves_jax_out():
    code = textwrap.dedent("""
        import sys
        import slowflow_tpu_torch
        import slowflow_tpu_torch.variational.multiframe
        import slowflow_tpu_torch.cli.slow_flow
        import slowflow_tpu_torch.kernels
        assert not slowflow_tpu_torch.runtime.kernels_available()
        print("jax" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _write_translating_sequence(seq_dir, u, v, h=48, w=64, n=8):
    """Smooth texture translating at (u, v) px/frame (PNG frames)."""
    from slowflow_tpu.io.images import write_image

    rng = np.random.default_rng(7)
    pad = 24
    base = rng.random((h + 2 * pad, w + 2 * pad, 3)) * 255
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    seq_dir.mkdir()
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


def _cfg(tmp_path, seq_dir, deep_matching=0, extra=""):
    cfg = tmp_path / "slow_flow.cfg"
    cfg.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{tmp_path}/sf_out
    Jets\t2
    start\t2
    max_fps\t40
    ref_fps\t20
    jet_fps\t40
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t{deep_matching}
    slow_flow_S\t2
    slow_flow_layers\t2
    slow_flow_p_scale\t0.8
    slow_flow_occlusion_reasoning\t1
    slow_flow_niter_alter\t2
    slow_flow_niter_outer\t4
    slow_flow_niter_solver\t20
    """) + extra)
    return cfg


def test_cli_stage2_on_cpu(tmp_path):
    from slowflow_tpu.io import read_flo
    from slowflow_tpu_torch.cli.slow_flow import main

    u, v = 1.0, 0.5
    seq_dir = tmp_path / "seq"
    _write_translating_sequence(seq_dir, u, v)
    rc = main([str(_cfg(tmp_path, seq_dir)), "-batch", "2", "-device", "cpu"])
    assert rc == 0
    out = tmp_path / "sf_out"
    assert (out / "config.cfg").exists()
    assert "slow_flow_img_norm_avg_1" in (out / "config.cfg").read_text()
    assert (out / "occlusion" / "frame_2.pbm").exists()
    inner = (slice(10, -10), slice(10, -10))
    for name, sign in (("frame_002.flo", 1), ("frame_003.flo", 1),
                       ("frame_003_back.flo", -1)):
        flow = read_flo(out / name)[inner]
        err = np.hypot(flow[..., 0] - sign * u, flow[..., 1] - sign * v)
        assert err.mean() < 0.1, (name, err.mean())
    # -resume finds every output and solves nothing
    rc = main([str(_cfg(tmp_path, seq_dir)), "-resume", "-device", "cpu"])
    assert rc == 0


def test_cli_route_keys_reach_the_route(tmp_path):
    """A cfg with the JAX package's route keys runs the stack route and the
    composed solve through the CLI: K3's and K5's wrappers are called, K1's
    and K2's are not."""
    from unittest import mock

    from slowflow_tpu.io import read_flo
    from slowflow_tpu_torch.cli.slow_flow import main

    seq_dir = tmp_path / "seq"
    _write_translating_sequence(seq_dir, 1.0, 0.5, h=32, w=40, n=6)
    cfg = _cfg(tmp_path, seq_dir, extra="slow_flow_merge_warp\t0\n"
               "slow_flow_fused_solve\t0\nslow_flow_pallas_sor\t1\n")
    spies = {name: mock.patch.object(tmf, name, wraps=getattr(tmf, name))
             for name in ("fused_data_system", "sor_coupled_rb_pallas",
                          "warp_stack", "warp_assemble", "solve_step")}
    called = {}
    with contextlib.ExitStack() as stack:
        for name, patch in spies.items():
            called[name] = stack.enter_context(patch)
        assert main([str(cfg), "-batch", "2", "-device", "cpu"]) == 0
    assert called["fused_data_system"].called
    assert called["sor_coupled_rb_pallas"].called
    assert called["warp_stack"].called
    assert not called["warp_assemble"].called
    assert not called["solve_step"].called
    flow = read_flo(tmp_path / "sf_out" / "frame_002.flo")[8:-8, 8:-8]
    assert np.hypot(flow[..., 0] - 1.0, flow[..., 1] - 0.5).mean() < 0.1


def test_cli_deep_matching_not_ported(tmp_path):
    from slowflow_tpu_torch.cli.slow_flow import main

    seq_dir = tmp_path / "seq"
    seq_dir.mkdir()
    with pytest.raises(NotImplementedError, match="EPIC"):
        main([str(_cfg(tmp_path, seq_dir, deep_matching=1)), "-device",
              "cpu"])
