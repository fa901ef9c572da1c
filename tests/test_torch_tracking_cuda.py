"""Stage 3 on the card against the same functions on the CPU, at the small
shapes of tests/test_torch_tracking.py, with the same proposal draws given
to both: energies and occlusion labels within 1e-4 relative / equal, the
selection MRF's labels >= 99 % equal, `track_final_pair` flows within 1e-3
px on >= 99 % of pixels with >= 99 % equal occlusion maps (with EPIC on,
its fits one launch of each kernel, also within the benchmark's limits:
mean end-point error <= 0.004 px, <= 4 % of pixels off by > 0.01 px or
with another occlusion flag), and the card's batched path equal to its
serial path. Every test needs a CUDA GPU and skips
without one.

    python -m pytest tests/test_torch_tracking_cuda.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.core.penalty import make_penalty
from slowflow_tpu_torch.tracking import driver, hypothesis, mrf
from test_tracking_batched import CFG, _job, _job_multirate
from test_torch_tracking import EPIC_CFG, MULTI_CFG, _epic_job, _hyp_inputs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.cpu() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("skip_pixel", [0, 1])
def test_energies_on_the_card(cuda_device, skip_pixel):
    d = {k: torch.as_tensor(v) for k, v in _hyp_inputs().items()}
    ep = hypothesis.EnergyParams(acc_cv=0.3, skip_pixel=skip_pixel)
    pen = make_penalty(1)
    keys = ("px", "py", "flows", "occl", "fwd", "data", "ddx", "ddy")

    def energy(dev):
        a = [d[k].to(dev) for k in keys]
        return hypothesis.hypothesis_energy(*a, pen, ep,
                                            d["occ_masks"].to(dev))

    assert _rel(energy(cuda_device), energy("cpu")) <= 1e-4
    occ = [hypothesis.set_occlusions(*(d[k].to(dev) for k in (
        "px", "py", "flows", "fwd", "bwd")), 1.5, 1.5)
        for dev in (cuda_device, "cpu")]
    torch.testing.assert_close(occ[0].cpu(), occ[1], rtol=0, atol=0)


@pytest.mark.cuda
def test_selection_on_the_card(cuda_device):
    d = _hyp_inputs(G=4)
    flows = torch.as_tensor(d["flows"]).clamp(-50, 50)
    occl = torch.as_tensor(d["occl"])
    sw = torch.as_tensor(np.random.default_rng(1).random((11, 13)),
                         dtype=torch.float32)
    unary = torch.as_tensor(np.random.default_rng(2).random((11, 13, 4)),
                            dtype=torch.float32) * 20
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        cost_r, cost_d = mrf.pairwise_costs(flows.to(dev), occl.to(dev),
                                            sw.to(dev), 10.0, 10.0, 1)
        out.append((cost_r, cost_d) + mrf.solve_multilabel(
            unary.to(dev), cost_r, cost_d, iters=10))
    (gr, gd, gl, ge, _), (tr, td, tl, te, _) = out
    assert _rel(gr, tr) <= 1e-4 and _rel(gd, td) <= 1e-4
    assert (gl.cpu() == tl).float().mean() >= 0.99
    assert abs(float(ge) - float(te)) <= 1e-4 * abs(float(te))


def _track(cfg, job, wj, dev):
    return driver.track_final_pair(
        cfg, job["rate_flows"], job["forward"], job["backward"],
        job["occlusions"], job["data"], job["data_dx"], job["data_dy"],
        job["smooth_weight"], wj, job.get("epic_ctx"), device=dev,
        draws=driver.default_draws(cfg.seed, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single", "multirate_occ", "epic"])
def test_track_final_pair_on_the_card(cuda_device, case):
    if case == "single":
        cfg, job, wj = CFG, _job(1.0, 0.5, 0), np.zeros(1, np.float32)
    elif case == "multirate_occ":
        cfg, job = MULTI_CFG, _job_multirate(1.0, 0.5, 0)
        wj = np.array([0.0, 1.0], np.float32)
    else:
        cfg, job = EPIC_CFG, _epic_job(_job(-0.7, 0.3, 1))
        wj = np.zeros(1, np.float32)
    kernels.reset_launch_counts()
    flow, occ, _ = _track(cfg, job, wj, cuda_device)
    fits = kernels.LAUNCHES["epic_fit"], kernels.LAUNCHES["epic_apply"]
    flow_c, occ_c, _ = _track(cfg, job, wj, "cpu")
    d = np.abs(flow - flow_c).max(-1)
    assert (d <= 1e-3).mean() >= 0.99, (d > 1e-3).mean()
    assert (occ == occ_c).mean() >= 0.99
    if case == "epic":
        # the EPIC hypotheses' fits on the card, the host's on the CPU:
        # the final pair within the benchmark's limits of `correct`
        assert fits == (1, 1)
        epe = np.hypot(*(flow - flow_c).transpose(2, 0, 1))
        assert epe.mean() <= 0.004
        assert ((epe > 0.01) | (occ != occ_c)).mean() <= 0.04


@pytest.mark.cuda
def test_batched_equals_serial_on_the_card(cuda_device):
    jobs = [_job(1.0, 0.5, 0), _job(-0.7, 0.3, 1)]
    wj = np.zeros(1, np.float32)
    draws = driver.default_draws(CFG.seed, "cpu")
    flows, occs, _ = driver.track_final_pairs_batched(
        CFG, jobs, wj, device=cuda_device, draws=draws, init_workers=2)
    for k, job in enumerate(jobs):
        flow_s, occ_s, _ = _track(CFG, job, wj, cuda_device)
        np.testing.assert_allclose(flows[k], flow_s, atol=1e-4)
        np.testing.assert_array_equal(occs[k], occ_s)
