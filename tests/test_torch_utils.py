"""The port's last helpers against the JAX package's, on the same seeded
inputs, on the CPU:

- `utils.tracing.StageTimer`: the same `summary()` and `write_info()` text
  under the same clock; `device_trace` writes a Chrome trace with events,
  and both packages' are no-ops without a directory;
- `utils.metrics.compute_aae` / `compute_rms` within 1e-12 (both float64);
- `core.warp.warp_image` / `warp_backward` within 1e-5 of the plane max,
  masks equal (float32 sums in another order: the JAX warp is a one-hot
  product);
- `core.solver.sor_coupled_reference` bit-equal (the same float64 steps), and
  the port's red-black `sor_coupled_rb` converging to it within 1e-3, as
  tests/test_core.py holds the JAX sweep;
- `io.images.is_16bit` on 8- and 16-bit PNGs;
- `cli.adaptive_fr.estimate_pair` within 1e-3 px of the JAX `estimate_pair`
  with the sintel presets (the batched EPIC and two-frame solve are held to
  JAX at 1e-5 px elsewhere; 1e-3 leaves room for the matcher's ties).
"""
import json
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowflow_tpu.cli import adaptive_fr as jadaptive
from slowflow_tpu.core import solver as jsolver
from slowflow_tpu.core import warp as jwarp
from slowflow_tpu.epic import EpicParams
from slowflow_tpu.io import images as jimages
from slowflow_tpu.utils import metrics as jmetrics
from slowflow_tpu.utils import tracing as jtracing
from slowflow_tpu.variational import TwoFrameParams
from slowflow_tpu_torch.cli import adaptive_fr
from slowflow_tpu_torch.core import solver, warp
from slowflow_tpu_torch.io import images
from slowflow_tpu_torch.utils import metrics, tracing

UNKNOWN = 1e10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread per worker keeps the parallel test
    run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _timed(timer_cls):
    """A timer with two stages (one twice) and two rows, under a clock that
    advances 0.25, 1.5 and 0.125 s."""
    ticks = iter([10.0, 10.25, 20.0, 21.5, 30.0, 30.125])
    with mock.patch("time.perf_counter", lambda: next(ticks)):
        t = timer_cls()
        with t.stage("epic"):
            pass
        with t.stage("solve"):
            pass
        with t.stage("epic"):
            pass
    t.add_row("jets", 4)
    t.add_row("avg", "0.5s")
    return t


def test_stage_timer_text(tmp_path):
    mine, theirs = _timed(tracing.StageTimer), _timed(jtracing.StageTimer)
    assert mine.summary() == theirs.summary()
    assert mine.summary() == ("epic took 0.38s (2 calls).\n"
                              "solve took 1.50s (1 calls).")
    for header in ("", "SlowFlow variational estimation"):
        mine.write_info(str(tmp_path / "mine.info"), header=header)
        theirs.write_info(str(tmp_path / "theirs.info"), header=header)
        assert (tmp_path / "mine.info").read_text() == \
            (tmp_path / "theirs.info").read_text()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    for log_dir in (None, ""):
        with tracing.device_trace(log_dir) as path:
            assert path is None
        with jtracing.device_trace(log_dir):
            pass
    assert list(tmp_path.iterdir()) == []
    log_dir = tmp_path / "trace"
    with tracing.device_trace(str(log_dir)) as path:
        x = torch.arange(1000.0).reshape(10, 100)
        (x @ x.T).sum()
    files = list(log_dir.iterdir())
    assert [str(f) for f in files] == [path]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _flows(rng, h=20, w=24):
    flow = rng.normal(size=(h, w, 2)) * 3
    gt = flow + rng.normal(size=(h, w, 2)) * 0.5
    flow[2, 3, 0] = UNKNOWN
    gt[5, 6, 1] = -UNKNOWN
    mask = rng.random((h, w)) > 0.3
    return flow.astype(np.float32), gt.astype(np.float32), mask


def test_aae_and_rms_match_jax(rng):
    flow, gt, mask = _flows(rng)
    for m in (None, mask):
        got = metrics.compute_aae(flow, gt, m)
        want = jmetrics.compute_aae(flow, gt, m)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
        assert got > 0
        assert abs(metrics.compute_epe(flow, gt, m)
                   - jmetrics.compute_epe(flow, gt, m)) <= 1e-12
    assert metrics.compute_aae(flow, np.full_like(gt, UNKNOWN)) == 0.0
    im1 = rng.random((3, 20, 24)).astype(np.float32) * 255
    im2 = rng.random((3, 20, 24)).astype(np.float32) * 255
    got, want = metrics.compute_rms(im1, im2), jmetrics.compute_rms(im1, im2)
    assert abs(got - want) <= 1e-12 * want


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_warp_image_matches_jax(rng, lead):
    h, w = 18, 22
    src = rng.random(lead + (h, w)).astype(np.float32) * 255
    wx = (rng.normal(size=(h, w)) * 2).astype(np.float32)
    wy = (rng.normal(size=(h, w)) * 2).astype(np.float32)
    got, got_mask = warp.warp_image(torch.as_tensor(src), torch.as_tensor(wx),
                                    torch.as_tensor(wy))
    want, want_mask = jwarp.warp_image(jnp.asarray(src), jnp.asarray(wx),
                                       jnp.asarray(wy))
    assert got.shape == want.shape and got_mask.shape == (h, w)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_warp_backward_matches_jax(rng, scale):
    h, w = 18, 22
    img = rng.random((3, h, w)).astype(np.float32) * 255
    flow, _, _ = _flows(rng, h, w)
    got = warp.warp_backward(torch.as_tensor(img), torch.as_tensor(flow),
                             scale)
    want = jwarp.warp_backward(jnp.asarray(img), jnp.asarray(flow), scale)
    _close(got.numpy(), want)
    assert float(got[:, 2, 3].abs().max()) == 0.0     # unknown flow


def _spd_system(rng, h, w):
    a11 = rng.random((h, w)).astype(np.float32) + 0.5
    a22 = rng.random((h, w)).astype(np.float32) + 0.5
    a12 = (rng.random((h, w)).astype(np.float32) - 0.5) * 0.2
    b1 = rng.normal(size=(h, w)).astype(np.float32)
    b2 = rng.normal(size=(h, w)).astype(np.float32)
    wh = rng.random((h, w)).astype(np.float32) * 0.5
    wv = rng.random((h, w)).astype(np.float32) * 0.5
    wh[:, -1] = 0
    wv[-1, :] = 0
    return a11, a12, a22, b1, b2, wh, wv


def test_sor_reference_matches_jax_and_rb_converges_to_it(rng):
    system = _spd_system(rng, 7, 9)
    du0 = rng.normal(size=(7, 9)).astype(np.float32)
    dv0 = rng.normal(size=(7, 9)).astype(np.float32)
    got = solver.sor_coupled_reference(du0, dv0, *system, iterations=4)
    want = jsolver.sor_coupled_reference(du0, dv0, *system, iterations=4)
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)

    h, w = 10, 12
    system = _spd_system(rng, h, w)
    zero = np.zeros((h, w), np.float32)
    ref = solver.sor_coupled_reference(zero, zero, *system, iterations=400)
    rb = solver.sor_coupled_rb(*(torch.as_tensor(a) for a in (zero, zero)
                                 + system), iterations=400, omega=1.9)
    for a, b in zip(rb, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3)


def test_is_16bit(tmp_path, rng):
    im = rng.random((12, 16, 3)) * 255
    images.write_image(tmp_path / "rgb8.png", im)
    images.write_image(tmp_path / "gray8.png", im[..., 0])
    images.write_image(tmp_path / "gray16.png", im[..., 0] * 200, bit16=True)
    for name, want in (("rgb8", False), ("gray8", False), ("gray16", True)):
        path = tmp_path / f"{name}.png"
        assert images.is_16bit(path) is want
        assert jimages.is_16bit(path) is want


def test_estimate_pair_matches_jax(rng):
    from slowflow_tpu_torch.bench_scene import moving_sequence

    frames = moving_sequence(2, 40, 56, 1.5, -0.8, seed=4).astype(np.float32)
    im1, im2 = np.round(frames[1]), np.round(frames[0])
    got = adaptive_fr.estimate_pair(im1, im2, device="cpu")
    want = jadaptive.estimate_pair(im1, im2, EpicParams.sintel(),
                                   TwoFrameParams.sintel())
    assert got.shape == want.shape == (40, 56, 2)
    assert np.abs(got - want).max() <= 1e-3
    with mock.patch("torch.cuda.is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no GPU"):
        adaptive_fr.estimate_pair(im1, im2)
