"""Plain PyTorch reference of the stage-2 jet solve on the route that
`cfgs/slow_flow.cfg` picks: occlusion reasoning on a symmetric window,
one inner iteration, so each alternation assembles the occlusion costs and
the first outer iteration's past / future systems in one pass, relabels
by ICM and solves; every further outer iteration assembles and solves.

It is a frozen copy of the port's eager torch-op code (the plain twins of
its kernels, the ICM, the pyramid), cut to that route and written to run
on any device in any floating dtype: float32 is the reference, bfloat16
the control that `correct` must reject. It imports nothing of the port.

Jets are a batch axis: a converged jet keeps its state while the others go
on, so a batch of any jets gives each jet's own answer.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

DATANORM = 0.1 * 0.1          # data-term normalization epsilon
DT_SCALE_GRAPHC = 0.01        # occlusion data-cost scale


# ----------------------------------------------------------- parameters
class Params:
    """The slow_flow_* keys of a configuration file, parsed."""

    def __init__(self, cfg: dict):
        self.S = int(cfg["slow_flow_S"])
        self.ref = self.S - 1
        self.rho = tuple(float(cfg[f"slow_flow_rho_{a}"])
                         for a in range(self.ref))
        self.omega = tuple(float(cfg[f"slow_flow_omega_{a}"])
                           for a in range(self.ref))
        self.alpha = float(cfg["slow_flow_alpha"])
        self.gamma = float(cfg["slow_flow_gamma"])
        self.delta = float(cfg["slow_flow_delta"])
        self.dataterm_norm = bool(int(cfg["slow_flow_dataterm"]))
        self.smoothing = int(cfg["slow_flow_smoothing"])
        self.layers = int(cfg["slow_flow_layers"])
        self.p_scale = float(cfg["slow_flow_p_scale"])
        self.niter_alter = int(cfg["slow_flow_niter_alter"])
        self.niter_graphc = int(cfg["slow_flow_niter_graphc"])
        self.niter_outer = int(cfg["slow_flow_niter_outer"])
        self.thres_outer = float(cfg["slow_flow_thres_outer"])
        self.niter_solver = int(cfg["slow_flow_niter_solver"])
        self.sor_omega = float(cfg["slow_flow_sor_omega"])
        self.occlusion_penalty = float(cfg["slow_flow_occlusion_penalty"])
        self.occlusion_alpha = float(cfg["slow_flow_occlusion_alpha"])
        self.color = Penalty(int(cfg["slow_flow_robust_color"]),
                             float(cfg["slow_flow_robust_color_eps"]),
                             float(cfg["slow_flow_robust_color_truncation"]))
        self.reg = Penalty(int(cfg["slow_flow_robust_reg"]),
                           float(cfg["slow_flow_robust_reg_eps"]),
                           float(cfg["slow_flow_robust_reg_truncation"]))
        self.hbit = bool(int(cfg["16bit"]))
        if not (int(cfg["slow_flow_occlusion_reasoning"])
                and cfg["slow_flow_method"] == "symmetric"
                and int(cfg["slow_flow_niter_inner"]) == 1
                and float(cfg["sigma"]) == 0):
            raise ValueError("the reference covers the occlusion-reasoning "
                             "route with a symmetric window, one inner "
                             "iteration and no presmoothing")


class Penalty:
    """Robust penalty on a squared residual: 0 quadratic, 1 modified L1,
    2 Lorentzian, 3 truncated modified L1, 4 Geman-McClure."""

    def __init__(self, fct: int, eps: float, trunc: float):
        self.fct, self.e2, self.trunc = fct, eps * eps, trunc
        self.trunc_value = float(np.sqrt(np.float32(trunc + eps * eps)))

    def apply(self, s):
        e2 = self.e2
        if self.fct == 0:
            return s
        if self.fct == 2:
            return torch.log1p(0.5 * s / e2)
        if self.fct == 3:
            return torch.where(torch.sqrt(s) > self.trunc,
                               torch.full_like(s, self.trunc_value),
                               torch.sqrt(s + e2))
        if self.fct == 4:
            return s / ((s + 1.0) * (s + 1.0))
        return torch.sqrt(s + e2)

    def derivative(self, s):
        e2 = self.e2
        if self.fct == 0:
            return torch.ones_like(s)
        if self.fct == 2:
            return 1.0 / (2.0 * e2 + s)
        if self.fct == 3:
            return torch.where(torch.sqrt(s) > self.trunc,
                               torch.zeros_like(s),
                               1.0 / (2.0 * torch.sqrt(s + e2)))
        if self.fct == 4:
            return (e2 + 2.0 * s) / ((e2 + s) * (e2 + s))
        return 1.0 / (2.0 * torch.sqrt(s + e2))


# ---------------------------------------------------------- image helpers
def _taps(half, even: bool) -> np.ndarray:
    half = np.asarray(half, np.float32)
    order = len(half) - 1
    taps = np.zeros(2 * order + 1, np.float32)
    for i in range(order + 1):
        taps[order - i] = half[i]
        taps[order + i] = half[i] if even else -half[i]
    return taps


DERIV_5PT = _taps([0.0, -8.0 / 12.0, 1.0 / 12.0], even=False)
DERIV_3PT = _taps([0.0, -0.5], even=False)


def shift_clamped(x, off: int, dim: int):
    """out[i] = x[clamp(i + off)] along `dim`."""
    if off == 0:
        return x
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device) + off).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _correlate(x, taps, dim: int):
    order = (len(taps) - 1) // 2
    out = None
    for k, c in enumerate(taps):
        if c == 0.0:
            continue
        term = float(c) * shift_clamped(x, k - order, dim)
        out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def conv_h(x, taps):
    return _correlate(x, taps, -1)


def conv_v(x, taps):
    return _correlate(x, taps, -2)


def gaussian_taps(sigma: float) -> np.ndarray:
    order = max(int(math.floor(3 * sigma)) + 1, 1)
    i = np.arange(-order, order + 1, dtype=np.float64)
    k = np.exp(-i * i / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def resize(x, new_h: int, new_w: int):
    """Antialiased bilinear resize of the trailing [H, W] axes (pixel
    centres aligned); computed in float32 whatever the dtype."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    out = F.interpolate(x.reshape(-1, 1, h, w).float(), size=(new_h, new_w),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(*lead, new_h, new_w).to(x.dtype)


def pyramid_sizes(h: int, w: int, layers: int, p_scale: float):
    sigma = 1.0 / math.sqrt(2.0 * p_scale)
    min_size = max(int(math.floor(3 * sigma)) + 1, 1) + 1
    sizes = [(h, w)]
    for _ in range(1, layers):
        ph, pw = sizes[-1]
        nh, nw = int(math.floor(ph * p_scale)), int(math.floor(pw * p_scale))
        if nh <= min_size or nw <= min_size:
            break
        sizes.append((nh, nw))
    return sizes


def pyramid(x, sizes, p_scale: float):
    taps = gaussian_taps(1.0 / math.sqrt(2.0 * p_scale))
    out = [x]
    for nh, nw in sizes[1:]:
        out.append(resize(conv_v(conv_h(out[-1], taps), taps), nh, nw))
    return out


def rescale_flow(wx, wy, new_h: int, new_w: int):
    fh, fw = new_h / wx.shape[-2], new_w / wx.shape[-1]
    return resize(wx, new_h, new_w) * fw, resize(wy, new_h, new_w) * fh


def normalize(frames):
    """Per jet: zero mean and std 255 per channel over its frames, the
    statistics in float64. frames [B, F, 3, H, W] in 0..255. Returns
    (normalized float32, avg [B, 3], std [B, 3] float32)."""
    x = frames.double()
    avg = x.mean((1, 3, 4))
    second = (x * x).mean((1, 3, 4))
    std = torch.sqrt(second - avg * avg) / 255.0
    a, s = avg[:, None, :, None, None], std[:, None, :, None, None]
    out = torch.where(s > 0, (x - a) / torch.where(s > 0, s, 1.0), x)
    return out.float(), avg.float(), std.float()


# ------------------------------------------------------------ the energy
def _const(values, like):
    return torch.tensor([float(v) for v in values], dtype=like.dtype,
                        device=like.device)


def _fold(x, dims=(-3,)):
    """Sum over small dims by explicit adds, first index first."""
    for dim in dims:
        parts = x.unbind(dim)
        x = parts[0]
        for part in parts[1:]:
            x = x + part
    return x


def smoothness(uu, vv, dpsis, alpha: float, pen: Penalty, method: int):
    """Edge-aware robust smoothness weights (wh, wv); methods 0 and 1."""
    if method not in (0, 1):
        raise ValueError("the reference covers smoothing 0 and 1")
    ux1 = F.pad(uu[..., :, 1:] - uu[..., :, :-1], (0, 1))
    vx1 = F.pad(vv[..., :, 1:] - vv[..., :, :-1], (0, 1))
    uy1 = F.pad(uu[..., 1:, :] - uu[..., :-1, :], (0, 0, 0, 1))
    vy1 = F.pad(vv[..., 1:, :] - vv[..., :-1, :], (0, 0, 0, 1))
    th_u = th_v = tv_u = tv_v = 0.0
    if method == 1:
        uy2, vy2 = conv_v(uu, DERIV_3PT), conv_v(vv, DERIV_3PT)
        ux2, vx2 = conv_h(uu, DERIV_3PT), conv_h(vv, DERIV_3PT)
        th_u = 0.5 * (uy2 + shift_clamped(uy2, 1, -1))
        th_v = 0.5 * (vy2 + shift_clamped(vy2, 1, -1))
        tv_u = 0.5 * (ux2 + shift_clamped(ux2, 1, -2))
        tv_v = 0.5 * (vx2 + shift_clamped(vx2, 1, -2))
    hsq = ux1 * ux1 + th_u * th_u + vx1 * vx1 + th_v * th_v
    vsq = uy1 * uy1 + tv_u * tv_u + vy1 * vy1 + tv_v * tv_v
    wh = (dpsis + shift_clamped(dpsis, 1, -1)) * alpha * pen.derivative(hsq)
    wv = (dpsis + shift_clamped(dpsis, 1, -2)) * alpha * pen.derivative(vsq)
    wh = wh.clone()
    wv = wv.clone()
    wh[..., :, -1] = 0.0
    wv[..., -1, :] = 0.0
    return wh, wv


def dpsis_weight(im, avg, std, hbit: bool):
    """0.5 exp(-5 |grad lum|) of the de-normalized reference frame."""
    scale = 65535.0 if hbit else 255.0

    def chan(c):
        return im[:, c] * std[:, c, None, None] + avg[:, c, None, None]

    lum = (0.299 * chan(0) + 0.587 * chan(1) + 0.114 * chan(2)) / scale
    lx, ly = conv_h(lum, DERIV_5PT), conv_v(lum, DERIV_5PT)
    return 0.5 * torch.exp(-5.0 * torch.sqrt(lx * lx + ly * ly))


def sub_laplacian(dst, src, wh, wv):
    """dst + div(w grad src)."""
    th = wh * (shift_clamped(src, 1, -1) - src)
    th[..., :, -1] = 0.0
    dst = dst + th - F.pad(th[..., :, :-1], (1, 0))
    tv = wv * (shift_clamped(src, 1, -2) - src)
    tv[..., -1, :] = 0.0
    return dst + tv - F.pad(tv[..., :-1, :], (0, 0, 1, 0))


def warp(src, wx, wy, factor: float):
    """src [B, C, H, W] sampled at (x + factor wx, y + factor wy), each
    corner clamped; the mask is 1 where the point lies inside."""
    h, w = src.shape[-2:]
    yy = torch.arange(h, device=src.device)[:, None].to(wx.dtype)
    xx = torch.arange(w, device=src.device, dtype=wx.dtype)[None, :]
    x = xx + factor * wx
    y = yy + factor * wy
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = (x - x0).unsqueeze(-3), (y - y0).unsqueeze(-3)
    x0i, y0i = x0.long(), y0.long()
    x0c, x1c = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
    y0c, y1c = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)
    flat = src.flatten(-2)

    def corner(yc, xc):
        idx = (yc * w + xc).flatten(-2).unsqueeze(-2)
        return flat.gather(-1, idx.expand(*flat.shape[:-1], h * w)) \
            .view(src.shape)

    top = (1.0 - dx) * corner(y0c, x0c) + dx * corner(y0c, x1c)
    bot = (1.0 - dx) * corner(y1c, x0c) + dx * corner(y1c, x1c)
    mask = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).to(src.dtype)
    return (1.0 - dy) * top + dy * bot, mask


def _past(n: int, ref: int, device, trailing: int):
    return (torch.arange(n, device=device) < ref).view(n, *([1] * trailing))


def _derivs(tmp, iz):
    ix, iy = conv_h(tmp, DERIV_5PT), conv_v(tmp, DERIV_5PT)
    return dict(ix=ix, iy=iy, iz=iz,
                ixx=conv_h(ix, DERIV_5PT), ixy=conv_v(ix, DERIV_5PT),
                iyy=conv_v(iy, DERIV_5PT),
                ixz=conv_h(iz, DERIV_5PT), iyz=conv_v(iz, DERIV_5PT))


def warped_window(seq, wx, wy, ref: int):
    """The window warped toward the reference frame, the successive and
    to-reference derivative stacks and the per-offset validity mask."""
    outs, masks = [], []
    for k in range(seq.shape[1]):
        if k == ref:
            outs.append(seq[:, k])
            masks.append(torch.ones_like(wx))
            continue
        o, m = warp(seq[:, k], wx, wy, float(k - ref))
        outs.append(o)
        masks.append(m)
    warped, masks = torch.stack(outs, 1), torch.stack(masks, 1)
    n = 2 * ref
    w_a, w_b = warped[:, :n], warped[:, 1:]
    succ = _derivs(0.5 * (w_a + w_b), w_a - w_b)
    ref_img = warped[:, ref:ref + 1]
    past = _past(n, ref, warped.device, 3)
    a_ref = torch.where(past, w_a, ref_img)
    b_ref = torch.where(past, ref_img, w_b)
    to_ref = _derivs(0.5 * (a_ref + b_ref), a_ref - b_ref)
    mask = torch.where(_past(n, ref, masks.device, 2), masks[:, :n],
                       masks[:, 1:])
    return succ, to_ref, mask


def offset_weights(p: Params):
    """Per-offset (rho, omega): past offset s uses index ref - 1 - s,
    future offset s uses s - ref."""
    idx = [p.ref - 1 - s if s < p.ref else s - p.ref
           for s in range(2 * p.ref)]
    return [p.rho[i] for i in idx], [p.omega[i] for i in idx]


def data_terms(mask, succ, to_ref, cw, p: Params):
    """IRLS normal equations (a11, a12, a22, b1, b2) at du = dv = 0."""
    rho, om = offset_weights(p)
    n = len(rho)
    rho_w = _const(rho, mask).view(n, 1, 1)
    omega_w = _const(om, mask).view(n, 1, 1)
    cw = cw.unsqueeze(-4)
    dims = (-3, -3)
    a11 = a12 = a22 = b1 = b2 = 0.0

    d = succ
    if p.delta != 0.0:
        t = cw * d["iz"]
        nrm = d["ix"] * d["ix"] + d["iy"] * d["iy"] + DATANORM
        w = mask * (rho_w * (p.delta / 3.0)) \
            * p.color.derivative(_fold(t * t / nrm))
        coef = w.unsqueeze(-3) * cw / nrm
        a11 = a11 + _fold(coef * d["ix"] * d["ix"], dims)
        a12 = a12 + _fold(coef * d["ix"] * d["iy"], dims)
        a22 = a22 + _fold(coef * d["iy"] * d["iy"], dims)
        b1 = b1 + _fold(coef * d["iz"] * d["ix"], dims)
        b2 = b2 + _fold(coef * d["iz"] * d["iy"], dims)
    if p.gamma != 0.0:
        ixx, ixy, iyy = d["ixx"], d["ixy"], d["iyy"]
        t1, t2 = cw * d["ixz"], cw * d["iyz"]
        n1 = ixx * ixx + ixy * ixy + DATANORM
        n2 = iyy * iyy + ixy * ixy + DATANORM
        w = mask * (rho_w * (p.gamma / 3.0)) \
            * p.color.derivative(_fold(t1 * t1 / n1 + t2 * t2 / n2))
        c1, c2 = w.unsqueeze(-3) * cw / n1, w.unsqueeze(-3) * cw / n2
        a11 = a11 + _fold(c1 * ixx * ixx + c2 * ixy * ixy, dims)
        a12 = a12 + _fold(c1 * ixx * ixy + c2 * ixy * iyy, dims)
        a22 = a22 + _fold(c2 * iyy * iyy + c1 * ixy * ixy, dims)
        b1 = b1 + _fold(c1 * ixx * d["ixz"] + c2 * ixy * d["iyz"], dims)
        b2 = b2 + _fold(c2 * iyy * d["iyz"] + c1 * ixy * d["ixz"], dims)

    fac = _const([float(s - p.ref) if s < p.ref else -float(s - p.ref + 1)
                  for s in range(n)], mask).view(n, 1, 1, 1)
    facsq = fac * fac
    d = to_ref
    if p.delta != 0.0:
        ix, iy, iz = d["ix"], d["iy"], d["iz"]
        t = cw * iz
        nrm = facsq * (ix * ix + iy * iy) + DATANORM
        w = mask * (omega_w * (p.delta / 3.0)) \
            * p.color.derivative(_fold(t * t / nrm))
        coef = w.unsqueeze(-3) * cw / nrm
        b1 = b1 - _fold(coef * fac * iz * ix, dims)
        b2 = b2 - _fold(coef * fac * iz * iy, dims)
        a11 = a11 + _fold(coef * facsq * ix * ix, dims)
        a12 = a12 + _fold(coef * facsq * ix * iy, dims)
        a22 = a22 + _fold(coef * facsq * iy * iy, dims)
    if p.gamma != 0.0:
        ixx, ixy, iyy = d["ixx"], d["ixy"], d["iyy"]
        ixz, iyz = d["ixz"], d["iyz"]
        t1, t2 = cw * ixz, cw * iyz
        n1 = facsq * (ixx * ixx + ixy * ixy) + DATANORM
        n2 = facsq * (iyy * iyy + ixy * ixy) + DATANORM
        w = mask * (omega_w * (p.gamma / 3.0)) \
            * p.color.derivative(_fold(t1 * t1 / n1 + t2 * t2 / n2))
        c1, c2 = w.unsqueeze(-3) * cw / n1, w.unsqueeze(-3) * cw / n2
        b1 = b1 - _fold(c1 * fac * ixx * ixz + c2 * fac * ixy * iyz, dims)
        b2 = b2 - _fold(c2 * fac * iyy * iyz + c1 * fac * ixy * ixz, dims)
        a11 = a11 + _fold(c1 * facsq * ixx * ixx + c2 * facsq * ixy * ixy,
                          dims)
        a12 = a12 + _fold(c1 * facsq * ixx * ixy + c2 * facsq * ixy * iyy,
                          dims)
        a22 = a22 + _fold(c2 * facsq * iyy * iyy + c1 * facsq * ixy * ixy,
                          dims)
    return a11, a12, a22, b1, b2


def occlusion_costs(mask, succ, to_ref, p: Params):
    """Data costs of the labels {0: occluded in the past, 1: in the
    future}."""
    n = 2 * p.ref
    rho_l, om_l = offset_weights(p)
    rho = _const(rho_l, mask).view(n, 1, 1)
    om = _const(om_l, mask).view(n, 1, 1)
    hd, hg = p.delta / 3.0, p.gamma / 3.0
    pen = p.color
    iz2 = _fold(succ["iz"] ** 2)
    gz2 = _fold(succ["ixz"] ** 2 + succ["iyz"] ** 2)
    iz2r = _fold(to_ref["iz"] ** 2)
    gz2r = _fold(to_ref["ixz"] ** 2 + to_ref["iyz"] ** 2)
    term = (rho * hd * mask * pen.apply(iz2) + rho * hg * mask * pen.apply(gz2)
            + om * hd * mask * pen.apply(iz2r)
            + om * hg * mask * pen.apply(gz2r))
    contrib = mask * (2.0 * rho + 2.0 * om)
    future = ~_past(n, p.ref, mask.device, 2)
    zero = torch.zeros((), dtype=mask.dtype, device=mask.device)
    e0 = _fold(torch.where(future, term, zero))
    n0 = _fold(torch.where(future, contrib, zero))
    e1 = _fold(torch.where(future, zero, term))
    n1 = _fold(torch.where(future, zero, contrib))
    n0 = torch.where(n0 == 0, torch.ones_like(n0), n0)
    n1 = torch.where(n1 == 0, torch.ones_like(n1), n1)
    return (DT_SCALE_GRAPHC * e0 / n0,
            DT_SCALE_GRAPHC * e1 / n1 + p.occlusion_penalty)


def direction_weights(occ, dn: float):
    factor = (1.0 + (occ == 0.0).to(occ.dtype)) * dn
    return (occ >= 0.0).to(occ.dtype) / factor, \
        (occ <= 0.0).to(occ.dtype) / factor


def gate(mask, occ, p: Params, dn: float):
    backward, forward = direction_weights(occ, dn)
    past = _past(2 * p.ref, p.ref, mask.device, 2)
    return mask * torch.where(past, backward.unsqueeze(-3),
                              forward.unsqueeze(-3))


def icm(e0, e1, alpha: float, iterations: int):
    """Binary Potts labels by red-black ICM from three starts (the data
    argmin, all 0, all 1), the start of least energy kept."""
    h, w = e0.shape[-2:]
    dev = e0.device
    red = (torch.arange(h, device=dev)[:, None]
           + torch.arange(w, device=dev)[None, :]) % 2 == 0
    ones = F.pad(torch.ones((h, w), dtype=e0.dtype, device=dev), (1, 1, 1, 1))
    deg = ones[:-2, 1:-1] + ones[2:, 1:-1] + ones[1:-1, :-2] + ones[1:-1, 2:]
    e0s, e1s = e0.unsqueeze(-3), e1.unsqueeze(-3)

    def half(lab, mask):
        cnt1 = (shift_clamped(lab, -1, -2) + shift_clamped(lab, 1, -2)
                + shift_clamped(lab, -1, -1) + shift_clamped(lab, 1, -1))
        c0 = e0s + alpha * cnt1
        c1 = e1s + alpha * (deg - cnt1)
        return torch.where(mask, (c1 < c0).to(lab.dtype), lab)

    lab = (e1 < e0).to(e0.dtype)
    cands = torch.stack([lab, torch.zeros_like(lab), torch.ones_like(lab)], -3)
    for _ in range(iterations):
        new = half(half(cands, red), ~red)
        settled = not bool((new != cands).any())
        cands = new
        if settled:
            break
    unary = torch.where(cands > 0.5, e1s, e0s)
    horiz = (cands[..., :, 1:] - cands[..., :, :-1]).abs()
    vert = (cands[..., 1:, :] - cands[..., :-1, :]).abs()
    energy = unary.sum((-2, -1)) + alpha * (horiz.sum((-2, -1))
                                            + vert.sum((-2, -1)))
    best = torch.argmin(energy, dim=-1)
    idx = best[..., None, None, None].expand(*best.shape, 1, h, w)
    return cands.gather(-3, idx).squeeze(-3)


def sor(a11, a12, a22, b1, b2, wh, wv, iterations: int, omega: float):
    """Red-black coupled 2x2-block SOR from zero."""
    h, w = a11.shape[-2:]

    def shift0(x, dy, dx):
        padded = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
        oy, ox = max(dy, 0), max(dx, 0)
        return padded[..., oy:oy + h, ox:ox + w]

    w_n, w_w, w_s, w_e = shift0(wv, -1, 0), shift0(wh, 0, -1), wv, wh
    sum_w = w_n + w_w + w_s + w_e
    A11, A22 = a11 + sum_w, a22 + sum_w
    det = A11 * A22 - a12 * a12
    det = torch.where(det == 0, torch.ones_like(det), det)
    i11, i12, i22 = A22 / det, -a12 / det, A11 / det
    red = (torch.arange(h, device=a11.device)[:, None]
           + torch.arange(w, device=a11.device)[None, :]) % 2 == 0

    def half(du, dv, mask):
        su = (w_n * shift0(du, -1, 0) + w_w * shift0(du, 0, -1)
              + w_s * shift0(du, 1, 0) + w_e * shift0(du, 0, 1))
        sv = (w_n * shift0(dv, -1, 0) + w_w * shift0(dv, 0, -1)
              + w_s * shift0(dv, 1, 0) + w_e * shift0(dv, 0, 1))
        B1, B2 = b1 + su, b2 + sv
        nu, nv = i11 * B1 + i12 * B2, i12 * B1 + i22 * B2
        du = torch.where(mask, (1 - omega) * du + omega * nu, du)
        dv = torch.where(mask, (1 - omega) * dv + omega * nv, dv)
        return du, dv

    du, dv = torch.zeros_like(a11), torch.zeros_like(a11)
    for _ in range(iterations):
        du, dv = half(du, dv, red)
        du, dv = half(du, dv, ~red)
    return du, dv


def _freeze(live, new, old):
    return torch.where(live.view(-1, *([1] * (new.dim() - 1))), new, old)


def one_level(wx, wy, seq, cw, avg, std, p: Params):
    """The alternating discrete / continuous minimization of one level.
    Returns (wx, wy, occ in {-1, +1})."""
    b = seq.shape[0]
    hw = seq.shape[-2] * seq.shape[-1]
    dn = float(sum(p.rho[s] + p.omega[s] for s in range(p.ref)))
    dev = seq.device
    dpsis = dpsis_weight(seq[:, p.ref], avg, std, p.hbit)
    occ = torch.full_like(wx, -1.0)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    inf = torch.full((b,), float("inf"), dtype=wx.dtype, device=dev)

    def solve(system):
        wh, wv = smoothness(wx, wy, dpsis, p.alpha, p.reg, p.smoothing)
        a11, a12, a22, b1, b2 = system
        b1 = sub_laplacian(b1, wx, wh, wv)
        b2 = sub_laplacian(b2, wy, wh, wv)
        ndu, ndv = sor(a11, a12, a22, b1, b2, wh, wv, p.niter_solver,
                       p.sor_omega)
        rate = torch.maximum(ndu.abs().sum((-2, -1)),
                             ndv.abs().sum((-2, -1))) / hw
        return ndu, ndv, rate

    for it in range(p.niter_alter):
        if it > 0 and not bool(alive.any()):
            break
        succ, to_ref, mask = warped_window(seq, wx, wy, p.ref)
        e0, e1 = occlusion_costs(mask, succ, to_ref, p)
        past = _past(2 * p.ref, p.ref, dev, 2)
        sys_b = data_terms(mask * past, succ, to_ref, cw, p)
        sys_f = data_terms(mask * ~past, succ, to_ref, cw, p)
        new_occ = occ
        if it > 0:
            new_occ = 2.0 * icm(e0, e1, p.occlusion_alpha,
                                p.niter_graphc) - 1.0
        backward, forward = direction_weights(new_occ, dn)
        first = tuple(backward * sb + forward * sf
                      for sb, sf in zip(sys_b, sys_f))
        stable = (new_occ != occ).to(wx.dtype).sum((-2, -1)) == 0 \
            if it > 0 else torch.zeros_like(alive)
        occ = _freeze(alive, new_occ, occ)
        live = alive
        ndu, ndv, rate = solve(first)
        wx = _freeze(live, wx + ndu, wx)
        wy = _freeze(live, wy + ndv, wy)
        change = torch.where(live, rate, inf)
        live = live & (change >= p.thres_outer)
        for _ in range(1, p.niter_outer):
            if not bool(live.any()):
                break
            succ, to_ref, mask = warped_window(seq, wx, wy, p.ref)
            ndu, ndv, rate = solve(data_terms(gate(mask, occ, p, dn), succ,
                                              to_ref, cw, p))
            wx = _freeze(live, wx + ndu, wx)
            wy = _freeze(live, wy + ndv, wy)
            change = torch.where(live, rate, change)
            live = live & (change >= p.thres_outer)
        alive = alive & ~(stable & (change < p.thres_outer))
    return wx, wy, occ


def solve_jets(frames, cfg: dict, dtype=torch.float32):
    """The stage-2 solve of jets from zero flow: frames [B, 2S-1, 3, H, W]
    in 0..255, each jet a window of its own scene, normalized per jet;
    channel weights of one. Returns (wx, wy, occ) [B, H, W] float32."""
    p = Params(cfg)
    seq, avg, std = normalize(frames)
    seq, avg, std = seq.to(dtype), avg.to(dtype), std.to(dtype)
    b, _, _, h, w = seq.shape
    cw = torch.ones((b, 3, h, w), dtype=dtype, device=seq.device)
    sizes = pyramid_sizes(h, w, p.layers, p.p_scale)
    pyr = pyramid(seq, sizes, p.p_scale)
    cw_pyr = pyramid(cw, sizes, p.p_scale)
    wx = torch.zeros((b,) + sizes[-1], dtype=dtype, device=seq.device)
    wy = torch.zeros_like(wx)
    occ = None
    for level in range(len(sizes) - 1, -1, -1):
        if level < len(sizes) - 1:
            wx, wy = rescale_flow(wx, wy, *sizes[level])
        wx, wy, occ = one_level(wx, wy, pyr[level], cw_pyr[level], avg, std,
                                p)
    return wx.float(), wy.float(), occ.float()
