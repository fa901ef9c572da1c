"""Plain PyTorch / NumPy reference of stage 3, dense tracking of one final
pair, as `cfgs/dense_tracking.cfg` runs it: hypotheses from the consistent
accumulation of each jet and from EPIC interpolation, then alternations of
propagation, NMS, unary and pairwise terms and the TRW-S solve.

A frozen copy of the port's eager torch-op code (its CUDA graphs replay the
same operations), but for the per-pixel steps over the whole bank (the
energies of a propagation pass, NMS, the pairwise costs), which run over
blocks of grid rows (`support.row_blocks`) so that the published scale
fits on one card, bit for bit the whole grid's values; with what the port
takes from elsewhere written here
(`support.py`): the seed graph's k nearest nodes by a Dijkstra in lockstep
over every source on the device, where the port calls its C++ library,
and the small-segment removal by flooding, where the port calls scipy.
It imports nothing of the port. From the frames and jet flows it works out
again what the stage-3 CLI derives: the normalization, the derivatives,
the smoothness weight, the Lab image and the edges of EPIC's context.
"""
from __future__ import annotations

import numpy as np
import torch

from .conv import DERIV_5PT, conv_horiz, conv_vert
from .driver import TrackingConfig, track_final
from .edges import detect_edges
from .image import normalize_sequence, resize_bilinear, rgb_to_lab
from .interp import EpicParams


def tracking_config(cfg: dict) -> TrackingConfig:
    """The acc_* keys of a configuration, with the stage-3 CLI's defaults;
    one frame rate."""
    def g(key, default, typ):
        raw = float(cfg.get(key, default))
        return typ(int(raw)) if typ in (bool, int) else raw

    return TrackingConfig(
        jets=int(cfg["Jets"]), rates=1,
        skip_pixel=g("acc_skip_pixel", "0", int),
        consistency_threshold=g("acc_consistency_threshold", "1.0", float),
        discard_inconsistent=g("acc_discard_inconsistent", "0", bool),
        use_jet_occlusions=g("acc_occlusion", "0", bool),
        epic_interpolation=g("acc_epic_interpolation", "1", bool),
        epic_skip=g("acc_epic_skip", "2", int),
        acc_jc=g("acc_jet_consistency", "1.0", float),
        acc_bc=g("acc_brightness_constancy", "0.1", float),
        acc_gc=g("acc_gradient_constancy", "1.0", float),
        acc_occ=g("acc_occlusion_penalty", "500.0", float),
        acc_beta=g("acc_beta", "10.0", float),
        acc_spatial_occ=g("acc_spatial_occ", "10.0", float),
        acc_cv=g("acc_cv", "0.0", float),
        acc_temporal_occ=g("acc_temporal_occ", "10.0", float),
        occlusion_threshold=g("acc_occlusion_threshold", "5.0", float),
        occlusion_fb_threshold=g("acc_occlusion_fb_threshold", "5.0", float),
        alternate=g("acc_alternate", "5", int),
        approach=g("acc_approach", "0", int),
        trws_eps=g("acc_trws_eps", "1e-5", float),
        trws_max_iter=g("acc_trws_max_iter", "10", int),
        neigh_hyp=g("acc_neigh_hyp", "5", int),
        neigh_hyp_radius=g("acc_neigh_hyp_radius", "100.0", float),
        hyp_neigh_tryouts=g("acc_hyp_neigh_tryouts", "20", int),
        traj_sim_method=g("acc_traj_sim_method", "1", int),
        traj_sim_thres=g("acc_traj_sim_thres", "0.1", float),
        penalty_fct_data=g("acc_penalty_fct_data", "1", int),
        capacity=g("acc_capacity", "16", int))


def smoothness_weight(img, avg, std, hbit: bool, device):
    """0.5 exp(-5 |grad lum|) of a normalized [3, H, W] image."""
    scale = 65535.0 if hbit else 255.0
    im = torch.as_tensor(np.asarray(img, np.float32), device=device)
    lum = (0.299 * (im[0] * std[0] + avg[0])
           + 0.587 * (im[1] * std[1] + avg[1])
           + 0.114 * (im[2] * std[2] + avg[2])) / scale
    lx, ly = conv_horiz(lum, DERIV_5PT), conv_vert(lum, DERIV_5PT)
    return (0.5 * torch.exp(-5.0 * torch.sqrt(lx * lx + ly * ly))) \
        .cpu().numpy()


def final_pair(frames, forward, backward, draws, cfg: dict, device,
               dtype=torch.float32):
    """The final flow [h, w, 2] and occlusion map [h, w] (uint8, 255 =
    occluded) of one final pair: frames [J+1, 3, H, W] in 0..255, forward /
    backward jet flows [J, H, W, 2], draws {(p_it, t): (ang, u)}; torch's
    float operations in `dtype` (float32 the reference, a lower precision
    the control)."""
    tc = tracking_config(cfg)
    hbit = bool(int(cfg["16bit"]))
    previous = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        raw = np.asarray(frames.float().cpu().numpy(), np.float32)
        stack, avg, std = normalize_sequence(raw)
        st = torch.as_tensor(stack, device=device).to(dtype)
        data_dx = conv_horiz(st, DERIV_5PT).permute(0, 2, 3, 1)
        data_dy = conv_vert(st, DERIV_5PT).permute(0, 2, 3, 1)
        sw = smoothness_weight(stack[0], avg, std, hbit, device)
        oh, ow = stack.shape[2:]
        ref8 = torch.as_tensor(raw[0] / 255.0 if hbit else raw[0],
                               device=device)
        if tc.skip_pixel:
            scale = 1.0 / (tc.skip_pixel + 1)
            ref8 = resize_bilinear(ref8, int(oh * scale), int(ow * scale))
        epic_ctx = (rgb_to_lab(ref8).cpu().numpy(),
                    detect_edges(ref8).cpu().numpy(), EpicParams.sintel())
        fwd, bwd = forward.to(dtype), backward.to(dtype)
        job = dict(rate_flows=[(fwd, bwd, None)], forward=fwd, backward=bwd,
                   occlusions=None, data=np.moveaxis(stack, 1, -1),
                   data_dx=data_dx, data_dy=data_dy, smooth_weight=sw,
                   epic_ctx=epic_ctx)

        def draw(p_it, t, ntry, h, w):
            ang, u = draws[(p_it, t)]
            return ang.to(dtype), u.to(dtype)

        return track_final(tc, job, draw, torch.device(device))
    finally:
        torch.set_default_dtype(previous)
