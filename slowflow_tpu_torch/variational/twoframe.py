"""Two-frame variational refinement, the original EpicFlow energy (torch
port of `slowflow_tpu.variational.twoframe`).

Colour and gradient constancy data terms with per-term normalization and an
edge-weighted TV-like smoothness, solved by IRLS: `niter_outer` warps, each
with `niter_inner` linearizations and `niter_solver` red-black coupled SOR
sweeps. The SOR step goes through `core.solver_pallas.sor_coupled_rb_pallas`:
K5 (csrc/solve_step.cu) on CUDA tensors, its plain twin
`core.solver.sor_coupled_rb` (the function the JAX version calls) on CPU
tensors. Every function batches over leading dims: images [..., 3, H, W],
planes [..., H, W].

On CUDA the whole refinement is one CUDA graph per shape, the counterpart
of the JAX package's jitted solve: its loops have fixed counts and it reads
nothing on the host, so `variational_twoframe_batched` runs it as one
segment of a cached `graphs.Program` (key `twoframe_key`) whose Slots hold
the inputs and the result, captured on the first call of a shape and
replayed after, bitwise the eager solve. The CPU runs it eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.conv import DERIV_3PT, DERIV_5PT, conv_horiz, conv_vert
from ..core.image import luminance
from ..core.solver_pallas import sor_coupled_rb_pallas
from ..core.warp import warp_bilinear
from ..runtime import as_f32, device_of, on_device
from . import graphs
from .terms import _east, _fold, _south, sub_laplacian

DATANORM = 0.1 * 0.1
EPS_COLOR = 0.001 * 0.001
EPS_GRAD = 0.001 * 0.001
EPS_SMOOTH = 0.001 * 0.001

@dataclass(frozen=True)
class TwoFrameParams:
    """variational_params_t with the reference defaults."""

    alpha: float = 1.0
    gamma: float = 0.71
    delta: float = 0.0
    sigma: float = 1.0
    niter_outer: int = 5
    niter_inner: int = 1
    niter_solver: int = 30
    sor_omega: float = 1.9

    @classmethod
    def sintel(cls):
        return cls(alpha=1.0, gamma=0.72, delta=0.0, sigma=1.1, niter_outer=5)

    @classmethod
    def kitti(cls):
        return cls(alpha=1.0, gamma=0.77, delta=0.0, sigma=1.7, niter_outer=2)

    @classmethod
    def middlebury(cls):
        return cls(alpha=1.0, gamma=0.72, delta=0.0, sigma=1.1,
                   niter_outer=25)


def get_derivatives(im1, w_im2):
    """Spatio-temporal derivatives on the mean of im1 and warped im2."""
    tmp = 0.5 * (im1 + w_im2)
    iz = w_im2 - im1
    ix = conv_horiz(tmp, DERIV_5PT)
    iy = conv_vert(tmp, DERIV_5PT)
    ixx = conv_horiz(ix, DERIV_5PT)
    ixy = conv_vert(ix, DERIV_5PT)
    iyy = conv_vert(iy, DERIV_5PT)
    ixz = conv_horiz(iz, DERIV_5PT)
    iyz = conv_vert(iz, DERIV_5PT)
    return ix, iy, iz, ixx, ixy, iyy, ixz, iyz


def compute_dpsis_weight(im, coef=5.0):
    """Local smoothness weight 0.5*exp(-coef*|grad(lum)|)."""
    lum = luminance(im)
    lx = conv_horiz(lum, DERIV_5PT)
    ly = conv_vert(lum, DERIV_5PT)
    return 0.5 * torch.exp(-coef * torch.sqrt(lx * lx + ly * ly))


def compute_smoothness(uu, vv, dpsis_weight, half_alpha):
    """Edge- and flow-gradient-weighted smoothness coefficients (wh, wv),
    with wh's last column and wv's last row zero."""
    ux1 = F.pad(uu[..., :, 1:] - uu[..., :, :-1], (0, 1))
    vx1 = F.pad(vv[..., :, 1:] - vv[..., :, :-1], (0, 1))
    uy1 = F.pad(uu[..., 1:, :] - uu[..., :-1, :], (0, 0, 0, 1))
    vy1 = F.pad(vv[..., 1:, :] - vv[..., :-1, :], (0, 0, 0, 1))
    ux2 = conv_horiz(uu, DERIV_3PT)
    vx2 = conv_horiz(vv, DERIV_3PT)
    uy2 = conv_vert(uu, DERIV_3PT)
    vy2 = conv_vert(vv, DERIV_3PT)

    t_u = 0.5 * (uy2 + _east(uy2))
    t_v = 0.5 * (vy2 + _east(vy2))
    hsq = ux1 * ux1 + t_u * t_u + vx1 * vx1 + t_v * t_v
    wh = (dpsis_weight + _east(dpsis_weight)) * half_alpha \
        / torch.sqrt(hsq + EPS_SMOOTH)
    wh[..., :, -1] = 0.0

    t_u = 0.5 * (ux2 + _south(ux2))
    t_v = 0.5 * (vx2 + _south(vx2))
    vsq = uy1 * uy1 + t_u * t_u + vy1 * vy1 + t_v * t_v
    wv = (dpsis_weight + _south(dpsis_weight)) * half_alpha \
        / torch.sqrt(vsq + EPS_SMOOTH)
    wv[..., -1, :] = 0.0
    return wh, wv


def compute_data_and_match(du, dv, mask, derivs, half_delta_over3,
                           half_gamma_over3):
    """IRLS data-term normal equations; derivs are [..., 3, H, W] each.
    Returns (a11, a12, a22, b1, b2) [..., H, W]."""
    ix, iy, iz, ixx, ixy, iyy, ixz, iyz = derivs
    du3 = du.unsqueeze(-3)
    dv3 = dv.unsqueeze(-3)
    zero = torch.zeros_like(du)
    a11 = a12 = a22 = b1 = b2 = zero

    if half_delta_over3 != 0.0:
        tmp = iz + ix * du3 + iy * dv3
        n = ix * ix + iy * iy + DATANORM
        w = mask * half_delta_over3 / torch.sqrt(_fold(tmp * tmp / n)
                                                 + EPS_COLOR)
        coef = w.unsqueeze(-3) / n
        a11 = a11 + _fold(coef * ix * ix)
        a12 = a12 + _fold(coef * ix * iy)
        a22 = a22 + _fold(coef * iy * iy)
        b1 = b1 - _fold(coef * iz * ix)
        b2 = b2 - _fold(coef * iz * iy)

    n1 = ixx * ixx + ixy * ixy + DATANORM
    n2 = iyy * iyy + ixy * ixy + DATANORM
    t1 = ixz + ixx * du3 + ixy * dv3
    t2 = iyz + ixy * du3 + iyy * dv3
    w = mask * half_gamma_over3 / torch.sqrt(
        _fold(t1 * t1 / n1 + t2 * t2 / n2) + EPS_GRAD)
    c1 = w.unsqueeze(-3) / n1
    c2 = w.unsqueeze(-3) / n2
    a11 = a11 + _fold(c1 * ixx * ixx + c2 * ixy * ixy)
    a12 = a12 + _fold(c1 * ixx * ixy + c2 * ixy * iyy)
    a22 = a22 + _fold(c2 * iyy * iyy + c1 * ixy * ixy)
    b1 = b1 - _fold(c1 * ixx * ixz + c2 * ixy * iyz)
    b2 = b2 - _fold(c2 * iyy * iyz + c1 * ixy * ixz)
    return a11, a12, a22, b1, b2


def _refine(wx, wy, im1, im2, params: TwoFrameParams):
    half_alpha = 0.5 * params.alpha
    half_gamma_over3 = params.gamma * 0.5 / 3.0
    half_delta_over3 = params.delta * 0.5 / 3.0
    dpsis_weight = compute_dpsis_weight(im1)
    for _ in range(params.niter_outer):
        w_im2, mask = warp_bilinear(im2, wx, wy)
        derivs = get_derivatives(im1, w_im2)
        du = torch.zeros_like(wx)
        dv = torch.zeros_like(wy)
        uu, vv = wx, wy
        for _ in range(params.niter_inner):
            wh, wv = compute_smoothness(uu, vv, dpsis_weight, half_alpha)
            a11, a12, a22, b1, b2 = compute_data_and_match(
                du, dv, mask, derivs, half_delta_over3, half_gamma_over3)
            b1 = sub_laplacian(b1, wx, wh, wv)
            b2 = sub_laplacian(b2, wy, wh, wv)
            du, dv = sor_coupled_rb_pallas(
                du, dv, a11, a12, a22, b1, b2, wh, wv,
                iterations=params.niter_solver, omega=params.sor_omega)
            uu, vv = wx + du, wy + dv
        wx, wy = uu, vv
    return wx, wy


def twoframe_key(device, params: TwoFrameParams, b: int, h: int, w: int):
    """The cache key of one two-frame solve's graph: the device, the
    params (a frozen dataclass, so hashable), the batch and image size."""
    return ("twoframe", torch.device(device), params, b, h, w)


def _refine_program(prog, wx, wy, im1, im2, params: TwoFrameParams):
    """`_refine` as one segment of `prog` (a graphs.Program, or Eager):
    the inputs go into its input slots, the segment writes the result into
    its state slots. Returns the state's (wx, wy)."""
    ins, st = prog.inputs, prog.state
    ins.wx, ins.wy, ins.im1, ins.im2 = wx, wy, im1, im2

    def refine():
        st.wx, st.wy = _refine(ins.wx, ins.wy, ins.im1, ins.im2, params)

    prog.run(("refine",), refine)
    return st.wx, st.wy


def variational_twoframe_batched(wx, wy, im1, im2,
                                 params: TwoFrameParams = TwoFrameParams(),
                                 *, device=None, _eager: bool = False):
    """Refine B flows (wx, wy) [B, H, W] between im1 and im2 [B, 3, H, W]
    (0..255) in one batched solve. Tensors or arrays; `device`: None = the
    device of `im1` if it is a tensor, else CUDA. Returns (wx, wy) tensors
    on that device.

    On CUDA the solve replays this host thread's cached CUDA graph of its
    shape (module docstring), bitwise the eager solve; the CPU runs it
    eagerly, and so does `_eager` (tests and chip_smoke.py only)."""
    device = device_of(im1, device)
    wx, wy, im1, im2 = (as_f32(a, device) for a in (wx, wy, im1, im2))
    if wx.dim() != 3:
        raise ValueError(f"wx: expected [B, H, W], got {tuple(wx.shape)}")
    key = twoframe_key(wx.device, params, *wx.shape)
    graphed = not _eager and device.type == "cuda"
    with on_device(device), graphs.running(key, device, graphed) as prog:
        wx, wy = _refine_program(prog, wx, wy, im1, im2, params)
        if not prog.graphed:
            return wx, wy
        return wx.clone(), wy.clone()


def variational_twoframe(wx, wy, im1, im2,
                         params: TwoFrameParams = TwoFrameParams(), *,
                         device=None):
    """`variational_twoframe_batched` of one pair: wx, wy [H, W], im1, im2
    [3, H, W]."""
    device = device_of(im1, device)
    wx, wy = variational_twoframe_batched(
        as_f32(wx, device)[None], as_f32(wy, device)[None],
        as_f32(im1, device)[None], as_f32(im2, device)[None], params,
        device=device)
    return wx[0], wy[0]
