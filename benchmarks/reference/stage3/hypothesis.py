"""Batched trajectory hypotheses (frozen copy of the port's
`tracking.hypothesis`).

The reference's per-pixel `hypothesis` objects (utils/hypothesis.{h,cpp}) are
fixed-capacity padded tensors with validity masks:

  flows   [H, W, K, J, 2]   per-jet *accumulated* flow (u, v)
  occl    [H, W, K, J + 1]  occlusion label per frame (0 visible, 1 occluded)
  energy  [H, W, K]
  valid   [H, W, K]
  jet_est [H, W, K]         source jet-estimation id

The energy functions take the per-final fields (forward [J, H, W, 2], data
[J + 1, H, W, 3], occlusion masks [J, H, W]) either as they are or with a
leading final-pair axis F ([F, J, H, W, 2], ...); with it, the hypothesis
tensors lead with F too ([F, H, W, K, J, 2]). Positions px / py broadcast
against the hypothesis dims. Loops over frames and window offsets are Python
loops; every pixel, hypothesis and final pair is updated at once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .penalty import Penalty
from .accumulate import _COORD_LIMIT, _inside, _norm, bilinear_sample

UNKNOWN = 1e10


def adapt_fps(flows, new_j: int):
    """Resample accumulated per-jet flow to a different jet count
    (hypothesis.h:136-178). flows [..., J, 2] -> [..., new_j, 2], numpy or
    torch."""
    J = flows.shape[-2]
    if J == new_j:
        return flows
    skip = J / new_j
    if skip >= 1:
        idx = (np.arange(new_j) * skip + (skip - 1)).astype(int)
        return flows[..., idx, :]
    cols = []
    for i in range(new_j):
        off = int(np.floor(i * skip))
        offm1 = int(np.floor((i - 1) * skip))
        if i > 0:
            last = flows[..., offm1, :]
        elif isinstance(flows, np.ndarray):
            last = np.zeros(flows.shape[:-2] + (2,), np.float32)
        else:
            last = flows.new_zeros(flows.shape[:-2] + (2,))
        cols.append(last + skip * (flows[..., off, :] - last))
    if isinstance(flows, np.ndarray):
        return np.stack(cols, axis=-2).astype(flows.dtype)
    return torch.stack(cols, dim=-2)


def _with_final_axis(field, field_dims, *hyp):
    """(batched, field [F, ...], hypothesis tensors [F, ...]): a field
    without the final-pair axis (`field_dims` dims) gets one of size 1, and
    so does every hypothesis tensor."""
    if field.dim() == field_dims + 1:
        return (True, field) + hyp
    return (False, field[None]) + tuple(
        None if t is None else t[None] for t in hyp)


def _positions(px, py, flows):
    """px, py broadcast to the hypothesis dims of flows [..., J, 2]."""
    shape = torch.broadcast_shapes(px.shape, flows.shape[:-2])
    return px.expand(shape), py.expand(shape)


# --------------------------------------------------------------------------
# occlusion estimation per hypothesis
# --------------------------------------------------------------------------
def set_occlusions(px, py, flows, forward, backward, occ_threshold,
                   fb_threshold):
    """Per-frame occlusion labels from jet-flow consistency + FB check
    (hypothesis::setOcclusions, hypothesis.cpp:172-221).

    px/py: [...]; flows: [..., J, 2] accumulated; forward/backward
    [J, H, W, 2] (or [F, J, H, W, 2] with flows [F, ..., J, 2]).
    Returns occl [..., J+1] int32 (occluded stays occluded).
    """
    batched, forward, flows, backward = _with_final_axis(
        forward, 4, flows, backward)
    J = flows.shape[-2]
    h, w = forward.shape[2:4]
    px, py = _positions(px, py, flows)

    occ_prev = torch.zeros(px.shape, dtype=torch.int32, device=flows.device)
    zero2 = torch.zeros_like(flows[..., 0, :])
    seq = [occ_prev]
    for t in range(J):
        prev = flows[..., t - 1, :] if t > 0 else zero2
        x_tm1 = px + prev[..., 0]
        y_tm1 = py + prev[..., 1]
        inside1 = _inside(x_tm1, y_tm1, w, h)
        F = bilinear_sample(forward[:, t], x_tm1.clamp(0, w - 1),
                            y_tm1.clamp(0, h - 1))
        cur = flows[..., t, :]
        jet_err = _norm(cur - prev - F)

        x_t = px + cur[..., 0]
        y_t = py + cur[..., 1]
        inside2 = _inside(x_t, y_t, w, h)
        B = bilinear_sample(backward[:, t], x_t.clamp(0, w - 1),
                            y_t.clamp(0, h - 1))
        fb_err = _norm(B + F)

        visible = (inside1 & inside2 & (fb_err < fb_threshold)
                   & (jet_err < occ_threshold))
        occ_prev = torch.where((occ_prev == 1) | ~visible, 1, 0).to(
            torch.int32)
        seq.append(occ_prev)
    out = torch.stack(seq, dim=-1)
    return out if batched else out[0]


# --------------------------------------------------------------------------
# energies (dense_tracking.cpp:176-365)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class EnergyParams:
    acc_jc: float = 1.0
    acc_bc: float = 0.1
    acc_gc: float = 1.0
    acc_occ: float = 500.0
    acc_cv: float = 0.0
    acc_temporal_occ: float = 10.0
    skip_pixel: int = 1


def add_jc(px, py, flows, occl, forward, pen: Penalty, p: EnergyParams):
    """Jet-consistency + constant-velocity energy (addJC,
    dense_tracking.cpp:176-233). flows [..., J, 2]; returns [...]."""
    batched, forward, flows, occl = _with_final_axis(forward, 4, flows, occl)
    J = flows.shape[-2]
    h, w = forward.shape[2:4]
    px, py = _positions(px, py, flows)
    zero2 = torch.zeros_like(flows[..., 0, :])
    jenergy = torch.zeros(px.shape, device=flows.device)
    cv = torch.zeros_like(jenergy)
    contrib = torch.zeros_like(jenergy)
    for t in range(J):
        u_j = flows[..., t, :]
        prev = flows[..., t - 1, :] if t > 0 else zero2
        nxt = flows[..., t + 1, :] if t + 1 < J else zero2

        x = px + prev[..., 0]
        y = py + prev[..., 1]
        inside = _inside(x, y, w, h)
        F = bilinear_sample(forward[:, t], x.clamp(0, w - 1),
                            y.clamp(0, h - 1))
        res = ((u_j - prev - F) ** 2).sum(-1)
        vis = (occl[..., t] == 0) & (occl[..., t + 1] == 0)
        known = u_j.abs().amax(-1) < UNKNOWN / 10
        use = inside & vis & known
        jenergy = jenergy + torch.where(use, 0.5 * pen.apply(res), 0.0)
        contrib = contrib + torch.where(use, 1.0, 0.0)

        # the reference's occluded-frame `continue` (dense_tracking.cpp:203)
        # also skips the constant-velocity term for inside-but-occluded jets
        cv_use = (~inside | vis) & known
        cv = cv + torch.where(cv_use, _norm(2 * u_j - prev - nxt), 0.0)
    jenergy = torch.where(contrib > 0, jenergy / contrib.clamp_min(1),
                          jenergy)
    out = p.acc_jc * jenergy + p.acc_cv * cv
    return out if batched else out[0]


_PAIRS: dict = {}


def _frame_pairs(n: int, device):
    """Index tensors (i, j) of the frame pairs i < j of n frames, made once
    per device (indexing by a Python list copies it from the host, which a
    CUDA graph capture refuses; shared: do not write)."""
    key = (n, torch.device(device))
    if key not in _PAIRS:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        _PAIRS[key] = tuple(torch.tensor(ix, dtype=torch.int64, device=device)
                            for ix in zip(*pairs))
    return _PAIRS[key]


def add_bcgc(px, py, flows, occl, data, data_dx, data_dy, p: EnergyParams,
             occ_masks=None):
    """Pairwise all-frames brightness / gradient constancy (addBCGC,
    dense_tracking.cpp:240-349), the hot energy term.

    For each pixel of a (2r+1)^2 window around p (r = (skip_pixel + 1) / 2),
    sample image + gradients bilinearly (clamp-at-border, utils.h:183-218)
    at the trajectory positions in all J+1 frames and average
    bc/3 |I_i - I_j| + gc/3 |G_i - G_j| over the visible frame pairs, then
    over the window pixels inside the image. The window offsets are a Python
    loop; per offset the four corners are gathered for every frame,
    hypothesis and final pair at once and all J(J+1)/2 frame pairs are
    reduced together into one [F, G, bh, bw] plane.

    data/data_dx/data_dy: [J+1, H, W, 3]; flows [bh, bw, G, J, 2] (leading
    dims broadcast against px/py [bh, bw, 1]); with a final-pair axis,
    [F, J+1, H, W, 3] and [F, bh, bw, G, J, 2]. `occ_masks` ([J, H, W],
    nonzero = visible: the jet occlusion maps when `acc_occlusion` is on,
    dense_tracking.cpp:289) additionally gates the samples of frames 1..J.
    Returns [bh, bw, G] (or [F, bh, bw, G]).
    """
    batched, data, flows, occl, data_dx, data_dy, occ_masks = \
        _with_final_axis(data, 4, flows, occl, data_dx, data_dy, occ_masks)
    nf, Jp1, h, w = data.shape[:4]
    dev = data.device
    r = int(0.5 * (p.skip_pixel + 1))
    bh, bw = torch.broadcast_shapes(px.shape[:2], flows.shape[1:3])
    G = flows.shape[3]
    flows = flows.expand(nf, bh, bw, G, Jp1 - 1, 2)
    occl = occl.expand(nf, bh, bw, G, Jp1)
    pxT = px[..., 0].expand(bh, bw)
    pyT = py[..., 0].expand(bh, bw)

    # trajectory positions and labels, frame-leading: [F, J+1, G, bh, bw]
    zero = torch.zeros((nf, 1, G, bh, bw), device=dev)
    cx = pxT + torch.cat([zero, flows[..., 0].permute(0, 4, 3, 1, 2)], 1)
    cy = pyT + torch.cat([zero, flows[..., 1].permute(0, 4, 3, 1, 2)], 1)
    cx = cx.clamp(-_COORD_LIMIT, _COORD_LIMIT)
    cy = cy.clamp(-_COORD_LIMIT, _COORD_LIMIT)
    occ_t = occl.permute(0, 4, 3, 1, 2)
    x0b = torch.floor(cx).to(torch.int64)
    y0b = torch.floor(cy).to(torch.int64)
    fx = (cx - x0b).clamp(0.0, 1.0)
    fy = (cy - y0b).clamp(0.0, 1.0)

    planes = torch.cat([data, data_dx, data_dy], -1)   # [F, J+1, H, W, 9]
    fi = torch.arange(nf, device=dev).view(nf, 1, 1, 1, 1)
    ti = torch.arange(Jp1, device=dev).view(1, Jp1, 1, 1, 1)
    pi, pj = _frame_pairs(Jp1, dev)
    bc_c = float(np.float32(p.acc_bc * 0.3334))
    gc_c = float(np.float32(p.acc_gc * 0.3334))

    e_sum = torch.zeros((nf, G, bh, bw), device=dev)
    neighs = torch.zeros((bh, bw), device=dev)
    for oy in range(-r, r + 1):
        for ox in range(-r, r + 1):
            center_inside = _inside(pxT + ox, pyT + oy, w, h)
            neighs = neighs + center_inside.float()
            xo = cx + ox
            yo = cy + oy
            vis = _inside(xo, yo, w, h) & center_inside & (occ_t == 0)
            if occ_masks is not None:
                xc = xo[:, 1:].clamp(0, w - 1).to(torch.int64)
                yc = yo[:, 1:].clamp(0, h - 1).to(torch.int64)
                seen = occ_masks[fi, ti[:, :-1], yc, xc] != 0
                vis = torch.cat([vis[:, :1], vis[:, 1:] & seen], 1)
            visf = vis.float()

            # the +1 row / column weighs 0 where it lies outside, exactly
            # as bilinear_sample's clamp-at-border
            xa, ya = x0b + ox, y0b + oy
            gx = (fx * (xa + 1 <= w - 1))[..., None]
            gy = (fy * (ya + 1 <= h - 1))[..., None]
            x0, x1 = xa.clamp(0, w - 1), (xa + 1).clamp(0, w - 1)
            y0, y1 = ya.clamp(0, h - 1), (ya + 1).clamp(0, h - 1)
            vals = planes[fi, ti, y0, x0] * (1 - gx) * (1 - gy)
            vals = vals + planes[fi, ti, y0, x1] * gx * (1 - gy)
            vals = vals + planes[fi, ti, y1, x0] * (1 - gx) * gy
            vals = vals + planes[fi, ti, y1, x1] * gx * gy

            d = (vals[:, pi] - vals[:, pj]).abs()   # [F, P, G, bh, bw, 9]
            wp = visf[:, pi] * visf[:, pj]
            e_pair = (bc_c * d[..., 0:3].sum(-1) + gc_c * d[..., 3:9].sum(-1))
            e_sum = e_sum + (e_pair * wp).sum(1) / wp.sum(1).clamp_min(1.0)
    e = (e_sum / neighs.clamp_min(1.0)).permute(0, 2, 3, 1)
    return e if batched else e[0]


def add_oc(occl, p: EnergyParams):
    """Occlusion count + temporal-change penalty (addOC,
    dense_tracking.cpp:351-365). occl [..., J+1]."""
    occ = occl.float()
    count = occ.sum(-1)
    change = (occ[..., 1:] - occ[..., :-1]).abs().sum(-1)
    return p.acc_occ * count + p.acc_temporal_occ * change


def hypothesis_energy(px, py, flows, occl, forward, data, data_dx, data_dy,
                      pen: Penalty, p: EnergyParams, occ_masks=None):
    """Full unary energy of a hypothesis (without the jet-estimation weight)."""
    return (add_jc(px, py, flows, occl, forward, pen, p)
            + add_bcgc(px, py, flows, occl, data, data_dx, data_dy, p,
                       occ_masks)
            + add_oc(occl, p))


# --------------------------------------------------------------------------
# trajectory distances (hypothesis.cpp:223-285)
# --------------------------------------------------------------------------
ADJ, ACC, FINAL = 0, 1, 2


def trajectory_distance(fa, fb, method: int):
    """Distance between accumulated-flow trajectories.

    fa/fb: [..., J, 2] broadcastable. ACC: mean over frames of ||diff||/l;
    ADJ: mean ||adjacent-flow diff||; FINAL: ||final-flow diff||.
    """
    J = fa.shape[-2]
    known = ((fa.abs().amax((-1, -2)) < UNKNOWN / 10)
             & (fb.abs().amax((-1, -2)) < UNKNOWN / 10))
    if method == FINAL:
        d = _norm(fa[..., -1, :] - fb[..., -1, :])
    elif method == ACC:
        l = torch.arange(1, J + 1, dtype=torch.float32, device=fa.device)
        d = (_norm(fa - fb) / l).sum(-1)
    else:  # ADJ
        da = torch.diff(fa, dim=-2, prepend=torch.zeros_like(fa[..., :1, :]))
        db = torch.diff(fb, dim=-2, prepend=torch.zeros_like(fb[..., :1, :]))
        d = _norm(da - db).mean(-1)
    return torch.where(known, d, 1e6)
