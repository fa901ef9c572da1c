"""Plain-tensor terms of the multi-frame energy (torch port of the array
functions of `slowflow_tpu.variational.multiframe`).

Every function takes optional leading batch dims: planes are [..., H, W],
window stacks [..., F, 3, H, W], per-offset stacks [..., N, 3, H, W] with
N = 2*ref offsets. These are the building blocks of the kernels' plain
twins (fused_warp.warp_assemble_ref, fused_data.fused_data_system_ref,
fused_solve.solve_step_ref), of the unfused route's derivative stacks and
assembly and of the occlusion step, which stay plain tensor code on every
device.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ..core.conv import DERIV_3PT, DERIV_5PT, conv_horiz, conv_vert, \
    shift_clamped
from ..core.warp import warp_bilinear
from ..core.rows import red_cells

# eager ICM calls by the number of sweeps they ran (solve_binary_potts)
ICM_SWEEPS: collections.Counter = collections.Counter()

DATANORM = 0.1 * 0.1          # data-term normalization epsilon
DT_SCALE_GRAPHC = 0.01        # occlusion data-cost scale


# device copies of small per-offset weight tables, made once per device: a
# copy from the host waits on the stream, which a CUDA graph capture refuses
_CONSTS: dict = {}


def _const(values, device) -> torch.Tensor:
    """float32 [n] tensor of `values` on `device` (shared: do not write)."""
    key = (tuple(float(v) for v in values), torch.device(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(key[0], dtype=torch.float32, device=device)
    return _CONSTS[key]


def _fold(x, dims=(-3,)):
    """Sum over small dims by explicit adds, first index first: unlike a
    threaded reduction, the order cannot depend on the thread count."""
    for dim in dims:
        parts = x.unbind(dim)
        x = parts[0]
        for part in parts[1:]:
            x = x + part
    return x


def _east(x):
    return shift_clamped(x, 1, -1)


def _south(x):
    return shift_clamped(x, 1, -2)


# ------------------------------------------------------------ smoothness
def compute_smoothness_mt(uu, vv, dpsis_weight, alpha, reg_penalty,
                          method: int):
    """Edge-aware robust smoothness weights (wh, wv).

    method 0: phi(u_dx) + phi(u_dy) per direction, no cross terms
    method 1: adds the averaged orthogonal derivative (EpicFlow scheme)
    method 2: one combined weight shared by both directions"""
    ux1 = F.pad(uu[..., :, 1:] - uu[..., :, :-1], (0, 1))
    vx1 = F.pad(vv[..., :, 1:] - vv[..., :, :-1], (0, 1))
    uy1 = F.pad(uu[..., 1:, :] - uu[..., :-1, :], (0, 0, 0, 1))
    vy1 = F.pad(vv[..., 1:, :] - vv[..., :-1, :], (0, 0, 0, 1))

    if method <= 1:
        if method == 1:
            ux2 = conv_horiz(uu, DERIV_3PT)
            vx2 = conv_horiz(vv, DERIV_3PT)
            uy2 = conv_vert(uu, DERIV_3PT)
            vy2 = conv_vert(vv, DERIV_3PT)
            th_u = 0.5 * (uy2 + _east(uy2))
            th_v = 0.5 * (vy2 + _east(vy2))
            tv_u = 0.5 * (ux2 + _south(ux2))
            tv_v = 0.5 * (vx2 + _south(vx2))
        else:
            th_u = th_v = tv_u = tv_v = 0.0
        hsq = ux1 * ux1 + th_u * th_u + vx1 * vx1 + th_v * th_v
        vsq = uy1 * uy1 + tv_u * tv_u + vy1 * vy1 + tv_v * tv_v
        wh = (dpsis_weight + _east(dpsis_weight)) * alpha \
            * reg_penalty.derivative(hsq)
        wv = (dpsis_weight + _south(dpsis_weight)) * alpha \
            * reg_penalty.derivative(vsq)
    else:
        h, w = uu.shape[-2:]
        has_e = torch.arange(w, device=uu.device)[None, :] < w - 1
        has_s = torch.arange(h, device=uu.device)[:, None] < h - 1
        zero = torch.zeros((), device=uu.device)
        sq = torch.where(has_e, ux1 * ux1 + vx1 * vx1, zero) \
            + torch.where(has_s, uy1 * uy1 + vy1 * vy1, zero)
        wsum = dpsis_weight + torch.where(has_e, _east(dpsis_weight), zero) \
            + torch.where(has_s, _south(dpsis_weight), zero)
        wh = wv = wsum * alpha * reg_penalty.derivative(sq)

    wh = wh.clone()
    wv = wv.clone()
    wh[..., :, -1] = 0.0
    wv[..., -1, :] = 0.0
    return wh, wv


def compute_dpsis_weight_mt(im, norm_avg, norm_std, coef=5.0, hbit=False):
    """0.5*exp(-coef*|grad lum|) on de-normalized intensities.
    im [..., 3, H, W]; norm_avg / norm_std [..., 3]."""
    scale = 65535.0 if hbit else 255.0

    def chan(c):
        return im[..., c, :, :] * norm_std[..., c, None, None] \
            + norm_avg[..., c, None, None]

    lum = (0.299 * chan(0) + 0.587 * chan(1) + 0.114 * chan(2)) / scale
    lx = conv_horiz(lum, DERIV_5PT)
    ly = conv_vert(lum, DERIV_5PT)
    return 0.5 * torch.exp(-coef * torch.sqrt(lx * lx + ly * ly))


def sub_laplacian(dst, src, wh, wv):
    """dst + div(w grad src)."""
    th = wh * (_east(src) - src)
    th[..., :, -1] = 0.0
    dst = dst + th - F.pad(th[..., :, :-1], (1, 0))
    tv = wv * (_south(src) - src)
    tv[..., -1, :] = 0.0
    return dst + tv - F.pad(tv[..., :-1, :], (0, 0, 1, 0))


# ------------------------------------------------------ derivative stacks
def warp_window_frames(seq, wx, wy, ref: int, rows=None):
    """Warp every window frame k by factor (k - ref); frame ref is the
    identity with an all-ones mask. seq [..., F, 3, H, W], flow [..., H, W];
    `rows`: strip windows' places in their image (core/warp.py).
    Returns (warped [..., F, 3, H, W], masks [..., F, H, W])."""
    outs, masks = [], []
    for k in range(seq.shape[-4]):
        if k == ref:
            outs.append(seq[..., k, :, :, :])
            masks.append(torch.ones_like(wx))
            continue
        o, m = warp_bilinear(seq[..., k, :, :, :], wx, wy, float(k - ref),
                             rows)
        outs.append(o)
        masks.append(m)
    return torch.stack(outs, -4), torch.stack(masks, -3)


def _past(n: int, ref: int, device, trailing: int):
    return (torch.arange(n, device=device) < ref).view(n, *([1] * trailing))


def succ_mask(masks, ref: int):
    """Data-term validity per offset: past offsets use frame s's warp mask,
    future ones frame s+1's. masks [..., F, H, W] -> [..., N, H, W]."""
    n = 2 * ref
    past = _past(n, ref, masks.device, 2)
    return torch.where(past, masks[..., :n, :, :], masks[..., 1:, :, :])


def _derivs(tmp, iz):
    ix = conv_horiz(tmp, DERIV_5PT)
    iy = conv_vert(tmp, DERIV_5PT)
    return dict(ix=ix, iy=iy, iz=iz,
                ixx=conv_horiz(ix, DERIV_5PT), ixy=conv_vert(ix, DERIV_5PT),
                iyy=conv_vert(iy, DERIV_5PT),
                ixz=conv_horiz(iz, DERIV_5PT), iyz=conv_vert(iz, DERIV_5PT))


def derivative_stacks(warped, ref: int):
    """Successive (s -> s+1) and to-reference derivative stacks of a warped
    window [..., F, 3, H, W]; each field [..., N, 3, H, W]."""
    n = 2 * ref
    w_a = warped[..., :n, :, :, :]
    w_b = warped[..., 1:, :, :, :]
    succ = _derivs(0.5 * (w_a + w_b), w_a - w_b)
    ref_img = warped[..., ref:ref + 1, :, :, :]
    past = _past(n, ref, warped.device, 3)
    a_ref = torch.where(past, w_a, ref_img)
    b_ref = torch.where(past, ref_img, w_b)
    to_ref = _derivs(0.5 * (a_ref + b_ref), a_ref - b_ref)
    return succ, to_ref


def get_derivatives_mt(seq, wx, wy, ref: int, warp=warp_window_frames):
    """Warp the window with `warp(seq, wx, wy, ref)` -> (warped, masks)
    (warp_window_frames' contract; the unfused route passes the K4 or K6
    wrapper) and build the derivative stacks.
    Returns (succ, to_ref, mask [..., N, H, W])."""
    warped, masks = warp(seq, wx, wy, ref)
    succ, to_ref = derivative_stacks(warped, ref)
    return succ, to_ref, succ_mask(masks, ref)


# ------------------------------------------------------------ data terms
def succ_weights(p):
    """Per-offset successive / to-reference weights: past offset s uses
    rho[ref-1-s], future rho[s-ref]; one_direction zeroes the past half."""
    ref = p.ref
    rho = [p.rho[ref - 1 - s] if s < ref else p.rho[s - ref]
           for s in range(2 * ref)]
    om = [p.omega[ref - 1 - s] if s < ref else p.omega[s - ref]
          for s in range(2 * ref)]
    if p.one_direction:
        rho = [0.0] * ref + rho[ref:]
        om = [0.0] * ref + om[ref:]
    return rho, om


def ref_factors(p):
    """Signed time factor of the to-reference linearization: s - ref for
    past offsets, -(s - ref + 1) for future ones."""
    ref = p.ref
    return [float(s - ref) if s < ref else -float(s - ref + 1)
            for s in range(2 * ref)]


def add_data_terms(du, dv, mask, succ, to_ref, channel_w, p):
    """IRLS normal equations of the successive and to-reference data terms
    over all offsets. Returns (a11, a12, a22, b1, b2), each [..., H, W]."""
    color_pen, grad_pen, _ = p.penalties()
    dev = mask.device
    rho, om = succ_weights(p)
    n = len(rho)
    rho_w = _const(rho, dev).view(n, 1, 1)
    omega_w = _const(om, dev).view(n, 1, 1)
    cw = channel_w.unsqueeze(-4)                     # [..., 1, 3, H, W]
    du = du.unsqueeze(-3).unsqueeze(-3)              # [..., 1, 1, H, W]
    dv = dv.unsqueeze(-3).unsqueeze(-3)
    dims = (-3, -3)                      # channels, then offsets

    a11 = a12 = a22 = b1 = b2 = 0.0

    ix, iy, iz = succ["ix"], succ["iy"], succ["iz"]
    ixx, ixy, iyy = succ["ixx"], succ["ixy"], succ["iyy"]
    ixz, iyz = succ["ixz"], succ["iyz"]

    if p.delta != 0.0:
        t = cw * (iz - ix * du - iy * dv)
        if p.dataterm_norm:
            nrm = ix * ix + iy * iy + DATANORM
            arg = _fold(t * t / nrm)
            w = mask * (rho_w * (p.delta / 3.0)) * color_pen.derivative(arg)
            coef = w.unsqueeze(-3) * cw / nrm
        else:
            arg = _fold(t * t)
            w = mask * (rho_w * (p.delta / 3.0)) * color_pen.derivative(arg)
            coef = w.unsqueeze(-3) * cw
        a11 = a11 + _fold(coef * ix * ix, dims)
        a12 = a12 + _fold(coef * ix * iy, dims)
        a22 = a22 + _fold(coef * iy * iy, dims)
        b1 = b1 + _fold(coef * iz * ix, dims)
        b2 = b2 + _fold(coef * iz * iy, dims)

    if p.gamma != 0.0:
        t1 = cw * (ixz - ixx * du - ixy * dv)
        t2 = cw * (iyz - ixy * du - iyy * dv)
        if p.dataterm_norm:
            n1 = ixx * ixx + ixy * ixy + DATANORM
            n2 = iyy * iyy + ixy * ixy + DATANORM
            arg = _fold(t1 * t1 / n1 + t2 * t2 / n2)
            w = mask * (rho_w * (p.gamma / 3.0)) * grad_pen.derivative(arg)
            c1 = w.unsqueeze(-3) * cw / n1
            c2 = w.unsqueeze(-3) * cw / n2
        else:
            arg = _fold(t1 * t1 + t2 * t2)
            w = mask * (rho_w * (p.gamma / 3.0)) * grad_pen.derivative(arg)
            c1 = c2 = w.unsqueeze(-3) * cw
        a11 = a11 + _fold(c1 * ixx * ixx + c2 * ixy * ixy, dims)
        a12 = a12 + _fold(c1 * ixx * ixy + c2 * ixy * iyy, dims)
        a22 = a22 + _fold(c2 * iyy * iyy + c1 * ixy * ixy, dims)
        b1 = b1 + _fold(c1 * ixx * ixz + c2 * ixy * iyz, dims)
        b2 = b2 + _fold(c2 * iyy * iyz + c1 * ixy * ixz, dims)

    fac = _const(ref_factors(p), dev).view(n, 1, 1, 1)
    facsq = fac * fac
    ix, iy, iz = to_ref["ix"], to_ref["iy"], to_ref["iz"]
    ixx, ixy, iyy = to_ref["ixx"], to_ref["ixy"], to_ref["iyy"]
    ixz, iyz = to_ref["ixz"], to_ref["iyz"]

    if p.delta != 0.0:
        t = cw * (iz + ix * fac * du + iy * fac * dv)
        if p.dataterm_norm:
            nrm = facsq * (ix * ix + iy * iy) + DATANORM
        else:
            nrm = facsq + torch.zeros_like(ix)
        arg = _fold(t * t / nrm)
        w = mask * (omega_w * (p.delta / 3.0)) * color_pen.derivative(arg)
        coef = w.unsqueeze(-3) * cw / nrm
        b1 = b1 - _fold(coef * fac * iz * ix, dims)
        b2 = b2 - _fold(coef * fac * iz * iy, dims)
        a11 = a11 + _fold(coef * facsq * ix * ix, dims)
        a12 = a12 + _fold(coef * facsq * ix * iy, dims)
        a22 = a22 + _fold(coef * facsq * iy * iy, dims)

    if p.gamma != 0.0:
        t1 = cw * (ixz + ixx * fac * du + ixy * fac * dv)
        t2 = cw * (iyz + ixy * fac * du + iyy * fac * dv)
        if p.dataterm_norm:
            n1 = facsq * (ixx * ixx + ixy * ixy) + DATANORM
            n2 = facsq * (iyy * iyy + ixy * ixy) + DATANORM
        else:
            n1 = n2 = facsq + torch.zeros_like(ixx)
        arg = _fold(t1 * t1 / n1 + t2 * t2 / n2)
        w = mask * (omega_w * (p.gamma / 3.0)) * grad_pen.derivative(arg)
        c1 = w.unsqueeze(-3) * cw / n1
        c2 = w.unsqueeze(-3) * cw / n2
        b1 = b1 - _fold(c1 * fac * ixx * ixz + c2 * fac * ixy * iyz, dims)
        b2 = b2 - _fold(c2 * fac * iyy * iyz + c1 * fac * ixy * ixz, dims)
        a11 = a11 + _fold(c1 * facsq * ixx * ixx + c2 * facsq * ixy * ixy, dims)
        a12 = a12 + _fold(c1 * facsq * ixx * ixy + c2 * facsq * ixy * iyy, dims)
        a22 = a22 + _fold(c2 * facsq * iyy * iyy + c1 * facsq * ixy * ixy, dims)

    return a11, a12, a22, b1, b2


def direction_weights(occ, data_norm: float):
    """Occlusion/direction gate per pixel: (backward, forward) weights for the
    past and future offsets of an occlusion plane in {-1, 0, +1}."""
    factor = (1.0 + (occ == 0.0).float()) * data_norm
    return (occ >= 0.0).float() / factor, (occ <= 0.0).float() / factor


def data_norm(p) -> float:
    return float(sum(p.rho[s] + p.omega[s] for s in range(p.ref)))


def gate_masks(mask, occ, p):
    """Occlusion/direction gating of the per-offset masks [..., N, H, W]."""
    backward, forward = direction_weights(occ, data_norm(p))
    past = _past(2 * p.ref, p.ref, mask.device, 2)
    gate = torch.where(past, backward.unsqueeze(-3), forward.unsqueeze(-3))
    if p.one_direction:
        gate = torch.where(past, torch.zeros_like(gate), gate)
    return mask * gate


# -------------------------------------------------------- occlusion MRF
def occlusion_data_costs(mask, succ, to_ref, p):
    """Data costs of labels {0: occluded in the past, 1: occluded in the
    future}. Returns (e0, e1), each [..., H, W]."""
    color_pen, grad_pen, _ = p.penalties()
    ref = p.ref
    n = 2 * ref
    dev = mask.device
    idx = [max(ref - s - 1, s - ref) for s in range(n)]
    rho = _const([p.rho[i] for i in idx], dev).view(n, 1, 1)
    om = _const([p.omega[i] for i in idx], dev).view(n, 1, 1)
    hd = p.delta / 3.0
    hg = p.gamma / 3.0

    iz2 = _fold(succ["iz"] ** 2)
    gz2 = _fold(succ["ixz"] ** 2 + succ["iyz"] ** 2)
    iz2r = _fold(to_ref["iz"] ** 2)
    gz2r = _fold(to_ref["ixz"] ** 2 + to_ref["iyz"] ** 2)

    term = (rho * hd * mask * color_pen.apply(iz2)
            + rho * hg * mask * grad_pen.apply(gz2)
            + om * hd * mask * color_pen.apply(iz2r)
            + om * hg * mask * grad_pen.apply(gz2r))
    contrib = mask * (2.0 * rho + 2.0 * om)

    future = ~_past(n, ref, dev, 2)
    zero = torch.zeros((), device=dev)
    e0 = _fold(torch.where(future, term, zero))
    n0 = _fold(torch.where(future, contrib, zero))
    e1 = _fold(torch.where(future, zero, term))
    n1 = _fold(torch.where(future, zero, contrib))
    n0 = torch.where(n0 == 0, torch.ones_like(n0), n0)
    n1 = torch.where(n1 == 0, torch.ones_like(n1), n1)
    return (DT_SCALE_GRAPHC * e0 / n0,
            DT_SCALE_GRAPHC * e1 / n1 + p.occlusion_penalty)


def solve_binary_potts(e0, e1, alpha: float, iterations: int, strips=None,
                       early_exit: bool = True):
    """Binary Potts MRF on the 4-connected grid by red-black ICM.

    Three starts (the data-cost argmin and both constant labelings) sweep
    together until none changes or `iterations` sweeps ran; the start with
    the lowest energy wins. A settled start is a fixed point, so running on
    until the last one settles changes nothing for it. The per-sweep changed
    flag is read on the host, and the sweeps run are counted in
    ICM_SWEEPS; with `early_exit` False all `iterations` sweeps run and
    nothing is read (the labels are the same: a settled start stays
    settled), as inside a CUDA graph. Returns labels {0, 1} as float32
    [..., H, W].

    `strips` (parallel/strips.py `Strips`): e0 / e1 [E, H, W] are strip
    windows. The colours follow the image's rows, `changed` looks at own
    rows on every strip, and each start's energy sums unary terms over own
    rows and pairs whose upper (or left) pixel is own over a jet's strips,
    so every strip of a jet picks the same start."""
    h, w = e0.shape[-2:]
    dev = e0.device
    red = red_cells(None if strips is None else strips.rows, h, w, dev)
    if strips is not None:
        red = red.unsqueeze(-3)
    ones = F.pad(torch.ones((h, w), dtype=e0.dtype, device=dev), (1, 1, 1, 1))
    deg = ones[:-2, 1:-1] + ones[2:, 1:-1] + ones[1:-1, :-2] + ones[1:-1, 2:]
    e0s = e0.unsqueeze(-3)
    e1s = e1.unsqueeze(-3)

    def cnt_ones(lab):
        return (shift_clamped(lab, -1, -2) + shift_clamped(lab, 1, -2)
                + shift_clamped(lab, -1, -1) + shift_clamped(lab, 1, -1))

    def half(lab, mask):
        cnt1 = cnt_ones(lab)
        c0 = e0s + alpha * cnt1
        c1 = e1s + alpha * (deg - cnt1)
        return torch.where(mask, (c1 < c0).to(lab.dtype), lab)

    lab = (e1 < e0).to(e0.dtype)
    cands = torch.stack([lab, torch.zeros_like(lab), torch.ones_like(lab)], -3)
    sweeps = 0
    for sweeps in range(1, iterations + 1):
        new = half(half(cands, red), ~red)
        settled = early_exit and not (
            bool((new != cands).any()) if strips is None
            else strips.any((new != cands) & strips.own.unsqueeze(-3)))
        cands = new
        if settled:
            break
    if early_exit:
        ICM_SWEEPS[sweeps] += 1

    unary = torch.where(cands > 0.5, e1s, e0s)
    horiz = (cands[..., :, 1:] - cands[..., :, :-1]).abs()
    vert = (cands[..., 1:, :] - cands[..., :-1, :]).abs()
    if strips is None:
        both = unary.sum((-2, -1))
        pw = horiz.sum((-2, -1)) + vert.sum((-2, -1))
    else:
        both = strips.jet_sum(strips.own_sum(unary))
        pw = strips.jet_sum(strips.own_sum(F.pad(horiz, (0, 1)))
                            + strips.own_sum(F.pad(vert, (0, 0, 0, 1))))
    best = torch.argmin(both + alpha * pw, dim=-1)          # [...]
    idx = best[..., None, None, None].expand(*best.shape, 1, h, w)
    return cands.gather(-3, idx).squeeze(-3)
