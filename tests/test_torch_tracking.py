"""Stage 3 of the port (`slowflow_tpu_torch.tracking`) against the JAX
package's `slowflow_tpu.tracking`, on the CPU.

Tolerances (float32 sums run in another order in the two packages):
- accumulation, sampling and energies: max |port - jax| <= 1e-5 of the
  plane's max |jax| (UNKNOWN entries must match exactly); `tracked` and the
  occlusion labels identical;
- numpy helpers (adapt_fps, complete_hypothesis, perturb_hypothesis): equal;
- the driver, with JAX's own proposal draws injected: flow within 1e-3 px on
  >= 99 % of pixels and >= 99 % equal occlusion maps (a near-tie in a sort
  or an argmin can flip one selection); the port's batched path equals its
  serial path (atol 1e-4, occlusions equal).
"""
from __future__ import annotations

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowflow_tpu.core.penalty import make_penalty as jax_penalty
from slowflow_tpu.tracking import accumulate as jacc
from slowflow_tpu.tracking import driver as jdrv
from slowflow_tpu.tracking import hypothesis as jhyp
from slowflow_tpu_torch.core.penalty import make_penalty
from slowflow_tpu_torch.tracking import accumulate as acc
from slowflow_tpu_torch.tracking import driver as drv
from slowflow_tpu_torch.tracking import hypothesis as hyp
from test_bcgc import _oracle as bcgc_oracle
from test_tracking_batched import CFG, _job, _job_multirate

UNKNOWN = 1e10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops run on tiny tensors here: one intra-op thread per
    worker keeps the parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|, with UNKNOWN / UNKNOWN_FLOW
    entries (>= 1e9) required at the same places."""
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    big = np.abs(want) >= 1e9
    np.testing.assert_array_equal(np.abs(got) >= 1e9, big)
    if (~big).any():
        scale = max(np.abs(want[~big]).max(), 1e-30)
        err = np.abs(got - want)[~big].max()
        assert err <= tol * scale, (err, scale)


def jax_draws(seed):
    """The JAX driver's own proposal draws for pass p_it, stride t."""
    def draws(p_it, t, ntry, h, w):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), p_it)
        k_ang, k_rad = jax.random.split(jax.random.fold_in(key, t))
        ang = jax.random.uniform(k_ang, (ntry, h, w), jnp.float32, 0.0,
                                 2 * np.pi)
        u = jax.random.uniform(k_rad, (ntry, h, w), jnp.float32)
        return np.array(ang), np.array(u)
    return draws


def _flows(rng, J, h, w, u=1.0, v=-0.5, noise=0.3):
    f = np.zeros((J, h, w, 2), np.float32)
    f[..., 0], f[..., 1] = u, v
    return f + rng.normal(0, noise, f.shape).astype(np.float32)


# --------------------------------------------------------------- accumulate
def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    field = rng.normal(0, 1, (13, 17, 3)).astype(np.float32)
    x = rng.uniform(-3, 20, (40, 5)).astype(np.float32)
    y = rng.uniform(-3, 16, (40, 5)).astype(np.float32)
    x[0, :3] = [0.0, 16.0, 15.5]
    y[0, :3] = [12.0, 0.0, 12.7]
    want = jacc.bilinear_sample(jnp.asarray(field), jnp.asarray(x),
                                jnp.asarray(y))
    close(acc.bilinear_sample(T(field), T(x), T(y)), want)
    # with a final-pair axis: one field per final
    fields = np.stack([field, 2 * field])
    got = acc.bilinear_sample(T(fields), T(np.stack([x, x])),
                              T(np.stack([y, y])))
    close(got[1], 2 * np.asarray(want))


@pytest.mark.parametrize("occ, discard, skip", [
    (False, False, 0), (True, False, 0), (True, True, 1), (False, True, 1)])
def test_accumulate_consistent_batches_matches_jax(occ, discard, skip):
    rng = np.random.default_rng(1)
    J, h, w = 5, 20, 26
    fwd = _flows(rng, J, h, w)
    bwd = -fwd + rng.normal(0, 0.2, fwd.shape).astype(np.float32)
    bwd[:, 5:9, 5:9] += 3.0                      # inconsistent block
    fwd[2, :, -3:, 0] = 4.0                      # runs out of the image
    occl = (rng.random((J, h, w)) > 0.1).astype(np.uint8) if occ else None
    want_acc, want_tr = jacc.accumulate_consistent_batches(
        fwd, bwd, occl, 0.5, skip, discard)
    got_acc, got_tr = acc.accumulate_consistent_batches(
        fwd, bwd, occl, 0.5, skip, discard, device="cpu")
    close(got_acc, want_acc)
    np.testing.assert_array_equal(got_tr.numpy(), np.asarray(want_tr))
    assert 0 < (np.asarray(want_tr) == J).mean() < 1


def test_off_path_accumulators_match_jax():
    rng = np.random.default_rng(2)
    J, h, w = 6, 18, 22
    fwd = _flows(rng, J, h, w, 1.3, 0.4)
    bwd = -fwd + rng.normal(0, 0.3, fwd.shape).astype(np.float32)
    occl = (rng.random((J, h, w)) < 0.05).astype(np.uint8)
    close(acc.accumulate_flow(fwd, occl, device="cpu"),
          jacc.accumulate_flow(fwd, occl))
    np.testing.assert_array_equal(
        acc.fuse_occlusions(fwd, occl, 1, 4, device="cpu"),
        jacc.fuse_occlusions(fwd, occl, 1, 4))
    mask = (rng.random((h // 2, w // 2)) > 0.2).astype(np.uint8)
    for g, want in zip(acc.accumulate_batches(fwd, bwd, mask, 3, 1,
                                              device="cpu"),
                       jacc.accumulate_batches(fwd, bwd, mask, 3, 1)):
        close(g, want)
    for jetwise in (False, True):
        for g, want in zip(
                acc.forward_backward_consistency(fwd, bwd, 3, 0.4, jetwise, 1,
                                                 device="cpu"),
                jacc.forward_backward_consistency(fwd, bwd, 3, 0.4, jetwise,
                                                  1)):
            close(g, want)
    for jetwise in (False, True):
        np.testing.assert_array_equal(
            acc.forward_backward_check(fwd, bwd, 0.4, jetwise, device="cpu"),
            jacc.forward_backward_check(fwd, bwd, 0.4, jetwise))


def test_accumulate_needs_a_device_for_arrays(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        acc.accumulate_flow(np.zeros((1, 4, 4, 2), np.float32),
                            np.zeros((1, 4, 4), np.uint8))


# --------------------------------------------------------------- hypothesis
def _hyp_inputs(seed=3, J=4, h=11, w=13, G=3):
    rng = np.random.default_rng(seed)
    per_jet = rng.normal(0, 1.2, (h, w, G, J, 2)).astype(np.float32) + 0.5
    flows = np.cumsum(per_jet, -2).astype(np.float32)
    flows[0, 0, 0] = 40.0                         # leaves the image
    flows[3, 4, 1] = UNKNOWN                      # unknown trajectory
    fwd = _flows(rng, J, h, w, 0.5, 0.5, 1.0)
    bwd = -fwd + rng.normal(0, 0.5, fwd.shape).astype(np.float32)
    data = rng.random((J + 1, h, w, 3)).astype(np.float32)
    ddx = rng.normal(0, 1, (J + 1, h, w, 3)).astype(np.float32)
    ddy = rng.normal(0, 1, (J + 1, h, w, 3)).astype(np.float32)
    occ_masks = (rng.random((J, h, w)) > 0.2).astype(np.uint8)
    occl = (rng.random((h, w, G, J + 1)) < 0.2).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return dict(px=xx[..., None], py=yy[..., None], flows=flows, fwd=fwd,
                bwd=bwd, data=data, ddx=ddx, ddy=ddy, occ_masks=occ_masks,
                occl=occl)


def test_set_occlusions_matches_jax():
    d = _hyp_inputs()
    want = jhyp.set_occlusions(jnp.asarray(d["px"]), jnp.asarray(d["py"]),
                               jnp.asarray(d["flows"]), jnp.asarray(d["fwd"]),
                               jnp.asarray(d["bwd"]), 1.5, 1.5)
    got = hyp.set_occlusions(T(d["px"]), T(d["py"]), T(d["flows"]),
                             T(d["fwd"]), T(d["bwd"]), 1.5, 1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.1 < np.asarray(want).mean() < 0.9


@pytest.mark.parametrize("skip_pixel, masks", [(0, False), (1, True)])
def test_energies_match_jax(skip_pixel, masks):
    d = _hyp_inputs()
    ep = hyp.EnergyParams(acc_cv=0.3, skip_pixel=skip_pixel)
    jep = jhyp.EnergyParams(acc_cv=0.3, skip_pixel=skip_pixel)
    om = d["occ_masks"] if masks else None
    jargs = [jnp.asarray(d[k]) for k in ("px", "py", "flows", "occl")]
    targs = [T(d[k]) for k in ("px", "py", "flows", "occl")]
    close(hyp.add_jc(*targs, T(d["fwd"]), make_penalty(1), ep),
          jhyp.add_jc(*jargs, jnp.asarray(d["fwd"]), jax_penalty(1), jep))
    got = hyp.add_bcgc(*targs, T(d["data"]), T(d["ddx"]), T(d["ddy"]), ep,
                       None if om is None else T(om))
    close(got, jhyp.add_bcgc(*jargs, jnp.asarray(d["data"]),
                             jnp.asarray(d["ddx"]), jnp.asarray(d["ddy"]),
                             jep, None if om is None else jnp.asarray(om)))
    close(hyp.add_oc(T(d["occl"]), ep), jhyp.add_oc(jnp.asarray(d["occl"]),
                                                    jep))
    close(hyp.hypothesis_energy(*targs, T(d["fwd"]), T(d["data"]),
                                T(d["ddx"]), T(d["ddy"]), make_penalty(1), ep,
                                None if om is None else T(om)),
          jhyp.hypothesis_energy(*jargs, jnp.asarray(d["fwd"]),
                                 jnp.asarray(d["data"]), jnp.asarray(d["ddx"]),
                                 jnp.asarray(d["ddy"]), jax_penalty(1), jep,
                                 None if om is None else jnp.asarray(om)))


def test_add_bcgc_matches_the_oracle():
    d = _hyp_inputs(seed=4, J=3, h=9, w=10, G=2)
    ep = hyp.EnergyParams(acc_bc=0.1, acc_gc=1.0, skip_pixel=1)
    for masks in (None, d["occ_masks"]):
        got = hyp.add_bcgc(T(d["px"]), T(d["py"]), T(d["flows"]),
                           T(d["occl"]), T(d["data"]), T(d["ddx"]),
                           T(d["ddy"]), ep,
                           None if masks is None else T(masks)).numpy()
        for (y, x, g) in [(0, 0, 0), (3, 4, 1), (5, 6, 0), (8, 9, 1),
                          (0, 9, 0), (4, 4, 1)]:
            want = bcgc_oracle(x, y, d["flows"][y, x, g], d["occl"][y, x, g],
                               d["data"], d["ddx"], d["ddy"], 0.1, 1.0, 1,
                               masks)
            assert abs(got[y, x, g] - want) < 5e-4, (y, x, g)


def test_energies_take_a_final_pair_axis():
    d = _hyp_inputs()
    ep = hyp.EnergyParams()
    one = hyp.hypothesis_energy(T(d["px"]), T(d["py"]), T(d["flows"]),
                                T(d["occl"]), T(d["fwd"]), T(d["data"]),
                                T(d["ddx"]), T(d["ddy"]), make_penalty(1), ep,
                                T(d["occ_masks"]))
    two = hyp.hypothesis_energy(
        T(d["px"]), T(d["py"]), T(np.stack([d["flows"]] * 2)),
        T(np.stack([d["occl"]] * 2)), T(np.stack([d["fwd"]] * 2)),
        T(np.stack([d["data"]] * 2)), T(np.stack([d["ddx"]] * 2)),
        T(np.stack([d["ddy"]] * 2)), make_penalty(1), ep,
        T(np.stack([d["occ_masks"]] * 2)))
    for f in range(2):
        torch.testing.assert_close(two[f], one, rtol=0, atol=0)


@pytest.mark.parametrize("method", [0, 1, 2], ids=["ADJ", "ACC", "FINAL"])
def test_trajectory_distance_matches_jax(method):
    d = _hyp_inputs()
    fa, fb = d["flows"][:, :, :, None], d["flows"][:, :, None]
    close(hyp.trajectory_distance(T(fa), T(fb), method),
          jhyp.trajectory_distance(jnp.asarray(fa), jnp.asarray(fb), method))


def test_numpy_helpers_equal_jax():
    rng = np.random.default_rng(5)
    flows = rng.normal(0, 2, (4, 5, 6, 2)).astype(np.float32)
    for new_j in (2, 3, 6, 9):
        np.testing.assert_array_equal(hyp.adapt_fps(flows, new_j),
                                      jhyp.adapt_fps(flows, new_j))
        np.testing.assert_array_equal(
            hyp.adapt_fps(T(flows), new_j).numpy(),
            np.asarray(jhyp.adapt_fps(jnp.asarray(flows), new_j)))
    px, py = rng.uniform(0, 20, (2, 4, 5))
    for start, end, approach in ((0, 6, 0), (1, 5, 1), (2, 3, 1)):
        got = hyp.complete_hypothesis(flows, start, end, px, py, approach)
        want = jhyp.complete_hypothesis(flows, start, end, px, py, approach)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hyp.perturb_hypothesis(flows, 0.3, -0.2),
                                  jhyp.perturb_hypothesis(flows, 0.3, -0.2))
    assert hyp.HypothesisSet.empty(3, 4, 5, 6).K == \
        jhyp.HypothesisSet.empty(3, 4, 5, 6).K


# ------------------------------------------------------------------- driver
def test_tracking_config_reads_the_cfg_keys_alike(tmp_path):
    from slowflow_tpu.config import ParameterList as JaxParameterList
    from slowflow_tpu_torch.config import ParameterList

    cfg = tmp_path / "dt.cfg"
    cfg.write_text(textwrap.dedent("""\
    acc_skip_pixel\t2
    acc_occlusion\t1
    acc_epic_skip\t3.0
    acc_brightness_constancy\t0.3
    acc_alternate\t3
    acc_approach\t1
    acc_trws_eps\t1e-4
    acc_neigh_hyp_radius\t50
    acc_traj_sim_method\t2
    acc_capacity\t12
    seed\t9
    """))
    mine, theirs = ParameterList(), JaxParameterList()
    mine.read(str(cfg))
    theirs.read(str(cfg))
    got = drv.TrackingConfig.from_parameter_list(mine, 4, 2)
    want = jdrv.TrackingConfig.from_parameter_list(theirs, 4, 2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.energy_params()) == \
        dataclasses.asdict(want.energy_params())


def _bank_pair(seed=6, h=5, w=6, K=5, J=3):
    """The same random bank for both packages (JAX [h, w, ...], the port
    [1, h, w, ...]), with invalid slots."""
    rng = np.random.default_rng(seed)
    flows = np.cumsum(rng.normal(0, 0.08, (h, w, K, J, 2)), -2).astype(
        np.float32)
    flows[..., 2, :, :] = flows[..., 1, :, :] + 0.01   # near-duplicates
    bank = dict(flows=flows,
                occl=(rng.random((h, w, K, J + 1)) < 0.3).astype(np.int32),
                energy=rng.random((h, w, K)).astype(np.float32),
                valid=rng.random((h, w, K)) < 0.7,
                jet_est=rng.integers(0, 2, (h, w, K)).astype(np.int32))
    bank["valid"][..., 0] = True
    bank["energy"] = np.where(bank["valid"], bank["energy"], np.inf).astype(
        np.float32)
    return ({k: jnp.asarray(v) for k, v in bank.items()},
            {k: T(v)[None] for k, v in bank.items()})


def _same_bank(got, want):
    """Banks equal on their valid slots (the JAX permute leaves 3e38 in the
    energy of invalid slots where the port keeps +inf)."""
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"][0].numpy(), valid)
    for k in ("flows", "occl", "energy", "jet_est"):
        np.testing.assert_array_equal(got[k][0].numpy()[valid],
                                      np.asarray(want[k])[valid])


def test_bank_operations_match_jax():
    jbank, tbank = _bank_pair()
    _same_bank(drv._bank_sort(tbank), jdrv._bank_sort(jbank))
    keep = np.random.default_rng(7).integers(0, 5, (5, 6)).astype(np.int32)
    _same_bank(drv._bank_truncate(drv._bank_sort(tbank, T(keep)[None]), 2),
               jdrv._bank_truncate(jdrv._bank_sort(jbank, jnp.asarray(keep)),
                                   2))
    sorted_t, sorted_j = drv._bank_sort(tbank), jdrv._bank_sort(jbank)
    _same_bank(drv._bank_nms(sorted_t, 1, 0.1), jdrv._bank_nms(sorted_j, 1,
                                                               0.1))
    rng = np.random.default_rng(8)
    flows = rng.normal(0, 1, (5, 6, 3, 2)).astype(np.float32)
    occl = np.ones((5, 6, 4), np.int32)
    energy = rng.random((5, 6)).astype(np.float32)
    mask = rng.random((5, 6)) < 0.5
    got, got_ins = drv._bank_insert(tbank, T(flows)[None], T(occl)[None],
                                    T(energy)[None], 1, T(mask)[None])
    want, want_ins = jdrv._bank_insert(jbank, jnp.asarray(flows),
                                       jnp.asarray(occl), jnp.asarray(energy),
                                       1, jnp.asarray(mask))
    _same_bank(got, want)
    np.testing.assert_array_equal(got_ins[0].numpy(), np.asarray(want_ins))
    sel = rng.integers(0, 5, (5, 6)).astype(np.int32)
    for g, w_ in zip(drv._readback(tbank["flows"], tbank["occl"], T(sel)[None],
                                   3, 2),
                     jdrv._readback(jbank["flows"], jbank["occl"],
                                    jnp.asarray(sel), 5, 3, 2)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w_))


def _epic_job(job, h=24, w=28):
    """A final pair with an EPIC context on the subsampled reference."""
    from slowflow_tpu_torch.core.image import resize_bilinear, rgb_to_lab
    from slowflow_tpu_torch.epic import EpicParams
    from slowflow_tpu_torch.epic.edges import detect_edges

    img = torch.as_tensor(np.moveaxis(job["data"][0], -1, 0).copy())
    small = resize_bilinear(img, h // 2, w // 2)
    return dict(job, epic_ctx=(rgb_to_lab(small).numpy(),
                               detect_edges(small).numpy(),
                               EpicParams.sintel()))


def _jax_epic_ctx(ctx):
    from slowflow_tpu.epic import EpicParams

    return (ctx[0], ctx[1], EpicParams.sintel())


def _run_jax(cfg, job, wj, epic=False):
    return jdrv.track_final_pair(
        cfg, job["rate_flows"], job["forward"], job["backward"],
        job["occlusions"], job["data"], job["data_dx"], job["data_dy"],
        job["smooth_weight"], wj,
        _jax_epic_ctx(job["epic_ctx"]) if epic else None)


def _run_port(cfg, job, wj, draws=None):
    return drv.track_final_pair(
        cfg, job["rate_flows"], job["forward"], job["backward"],
        job["occlusions"], job["data"], job["data_dx"], job["data_dy"],
        job["smooth_weight"], wj, job.get("epic_ctx"), device="cpu",
        draws=draws)


def _agree(flow, occ, flow_j, occ_j):
    assert flow.shape == np.asarray(flow_j).shape
    d = np.abs(flow - np.asarray(flow_j)).max(-1)
    assert (d <= 1e-3).mean() >= 0.99, (d > 1e-3).mean()
    assert (occ == np.asarray(occ_j)).mean() >= 0.99


MULTI_CFG = dataclasses.replace(CFG, rates=2, use_jet_occlusions=True,
                                seed=7)
EPIC_CFG = dataclasses.replace(CFG, epic_interpolation=True, acc_bc=0.1,
                               acc_gc=1.0)


@pytest.mark.parametrize("case", ["single", "multirate_occ", "epic"])
def test_track_final_pair_matches_jax(case):
    if case == "single":
        cfg, job, wj = CFG, _job(1.0, 0.5, 0), np.zeros(1, np.float32)
    elif case == "multirate_occ":
        cfg, job = MULTI_CFG, _job_multirate(1.0, 0.5, 0)
        wj = np.array([0.0, 1.0], np.float32)
    else:
        cfg, job = EPIC_CFG, _epic_job(_job(-0.7, 0.3, 1))
        wj = np.zeros(1, np.float32)
    flow_j, occ_j, info_j = _run_jax(cfg, job, wj, epic=case == "epic")
    flow, occ, info = _run_port(cfg, job, wj, jax_draws(cfg.seed))
    _agree(flow, occ, flow_j, occ_j)
    assert info["variables"] == info_j["variables"]
    assert info["factors"] == info_j["factors"]
    assert set(info["timing"]) == set(info_j["timing"])


def test_initial_bank_matches_jax():
    job = _epic_job(_job(1.0, 0.5, 2))
    wj = np.zeros(1, np.float32)
    jbank, jcons = jdrv._init_final_state(
        EPIC_CFG, job["rate_flows"], job["forward"], job["backward"], None,
        job["data"], job["data_dx"], job["data_dy"], wj,
        _jax_epic_ctx(job["epic_ctx"]), {})
    state = drv._init_final_state(EPIC_CFG, job, wj, torch.device("cpu"), {})
    np.testing.assert_array_equal(state["consistent"][0].numpy(), jcons)
    valid = np.asarray(jbank["valid"])
    assert valid.sum(-1).min() >= 2             # accumulation + EPIC slots
    np.testing.assert_array_equal(state["valid"][0].numpy(), valid)
    np.testing.assert_array_equal(state["occl"][0].numpy(),
                                  np.asarray(jbank["occl"]))
    close(state["flows"][0], jbank["flows"])
    close(state["energy"][0].numpy()[valid],
          np.asarray(jbank["energy"])[valid])


def test_batched_matches_jax_and_serial():
    """The port's batch of 2 against the JAX package's serial runs (its own
    tests hold its batched path to them) and against the port's serial
    runs and threaded initialization."""
    jobs = [_job(1.0, 0.5, 0), _job(-0.7, 0.3, 1)]
    wj = np.zeros(1, np.float32)
    flows, occs, info = drv.track_final_pairs_batched(
        CFG, jobs, wj, device="cpu", draws=jax_draws(CFG.seed))
    threaded = drv.track_final_pairs_batched(
        CFG, jobs, wj, device="cpu", draws=jax_draws(CFG.seed),
        init_workers=2)
    assert len(info["variables"]) == CFG.alternate
    for k, job in enumerate(jobs):
        _agree(flows[k], occs[k], *_run_jax(CFG, job, wj)[:2])
        flow_s, occ_s, _ = _run_port(CFG, job, wj, jax_draws(CFG.seed))
        np.testing.assert_allclose(flows[k], flow_s, atol=1e-4)
        np.testing.assert_array_equal(occs[k], occ_s)
        np.testing.assert_array_equal(threaded[0][k], flows[k])
        np.testing.assert_array_equal(threaded[1][k], occs[k])


def test_default_draws_batched_equals_serial():
    """With the port's own draws (seeded per pass and stride), batched and
    serial runs propose the same candidates."""
    jobs = [_job_multirate(1.0, 0.5, 0), _job_multirate(-0.6, 0.4, 1)]
    wj = np.array([0.0, 1.0], np.float32)
    flows, occs, _ = drv.track_final_pairs_batched(MULTI_CFG, jobs, wj,
                                                   device="cpu")
    for k, job in enumerate(jobs):
        flow_s, occ_s, _ = _run_port(MULTI_CFG, job, wj)
        np.testing.assert_allclose(flows[k], flow_s, atol=1e-4)
        np.testing.assert_array_equal(occs[k], occ_s)


def test_draw_semantics():
    """Truncation toward zero and floor division onto the lattice, at x = 0
    and on negative offsets, as the JAX driver's int32 arithmetic."""
    draws = drv.default_draws(3, "cpu")
    ang, u = draws(1, 0, 4, 5, 6)
    again, _ = draws(1, 0, 4, 5, 6)
    torch.testing.assert_close(ang, again, rtol=0, atol=0)
    assert float(ang.min()) >= 0 and float(ang.max()) < 2 * np.pi
    assert float(u.min()) >= 0 and float(u.max()) < 1
    assert not torch.equal(draws(1, 1, 4, 5, 6)[0], ang)
    x = torch.tensor([-0.7, 0.0, 0.9, 3.5])
    assert x.to(torch.int64).tolist() == [0, 0, 0, 3]
    s = torch.tensor([0, 1, 2, 5])
    assert (torch.div(s - 1, 2, rounding_mode="floor") * 2 + 1).tolist() == \
        [-1, 1, 1, 5]
    assert np.asarray((jnp.asarray([0, 1, 2, 5]) - 1) // 2 * 2 + 1).tolist() \
        == [-1, 1, 1, 5]


def test_track_final_pair_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = _job(1.0, 0.5, 0)
    with pytest.raises(RuntimeError, match="no GPU"):
        drv.track_final_pair(CFG, job["rate_flows"], job["forward"],
                             job["backward"], None, job["data"],
                             job["data_dx"], job["data_dy"],
                             job["smooth_weight"])
