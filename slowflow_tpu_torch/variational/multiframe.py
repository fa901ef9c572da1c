"""Multi-frame, occlusion-aware variational flow: the stage-2 jet solve
(torch port of `slowflow_tpu.variational.multiframe`).

Jets are a batch axis, not a loop. Each loop level keeps a per-jet `live`
flag on the device; a jet that has converged keeps its state (torch.where),
which reproduces the per-jet exits of the JAX package's unrolled jets. The
loop-exit tests read `live.any()` on the host once per iteration.

The kernels that carry one level follow `p.route()` (params.py):
  merged   the state is the flow itself; K2 warps and assembles per call;
  stack    the state is (warped window, raw mask): K4 warps once per outer
           iteration, K3 assembles from the stack with the gated mask;
  unfused  the state is (succ, to_ref, mask) derivative stacks built with
           torch ops from a K4 (or, with pallas_warp, K6) warp; assembly and
           occlusion costs are torch ops.
The state is derived at the top of each alternation and again before each
further outer iteration (never on the exit iteration). The solve is K1
(fused) or smoothness + Laplacian RHS as torch ops, then K5 (composed).

Per alternation on the fused-occlusion route (merged, self-masking,
occlusion reasoning, symmetric window, niter_inner == 1): one K2
`occ_assembly` call yields the occlusion data costs and the first outer
iteration's normal equations split into past / future offsets; ICM updates
the labels (from the second alternation on); the occlusion gate folds the
two halves into one system; a peeled outer iteration solves it from zero;
every further outer iteration assembles and solves. Every other route
takes the plain order: the `occ` costs (from the second alternation on),
then one assembly and one solve per outer (and inner) iteration.

With a strip plan (`strips`, parallel/strips.py) the batch holds strip
windows of taller images: the kernels take the windows' places, the ghost
rows are refreshed after each solve and each relabel, per-jet sums cover
own rows and add over a jet's strips, and the windows widen before a warp
when the flow outgrows them. Without one every hook is skipped.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.image import build_pyramid, pyramid_sizes, rescale_flow
from ..core.solver_pallas import sor_coupled_rb_pallas
from ..core.warp_pallas import warp_stack_pallas
from ..core.warp_shift import warp_stack
from ..parallel.mesh import make_mesh, run_sharded
from ..runtime import as_f32, device_of, on_device
from .fused_data import fused_data_system
from .fused_solve import solve_step
from .fused_warp import warp_assemble
from .params import MultiFrameParams
from .terms import (add_data_terms, compute_dpsis_weight_mt,
                    compute_smoothness_mt, data_norm, direction_weights,
                    gate_masks, get_derivatives_mt, occlusion_data_costs,
                    solve_binary_potts, sub_laplacian, succ_mask)


def _freeze(live, new, old):
    """`new` for live jets, `old` for the rest ([B, ...] tensors)."""
    return torch.where(live.view(-1, *([1] * (new.dim() - 1))), new, old)


def _window_warp_pallas(seq, wx, wy, ref: int, rows=None):
    """K6's entry on a window: every frame k warped by (k - ref), the
    reference frame included, as the JAX package's pallas_warp route does."""
    return warp_stack_pallas(seq, wx, wy,
                             [k - ref for k in range(seq.shape[1])], rows)


def _level_state(route, seq, channel_w, p: MultiFrameParams, rows=None):
    """The route's (derive, occ_costs, data_terms):
    derive(wx, wy) -> state; occ_costs(state) -> (e0, e1);
    data_terms(state, du, dv, occ) -> (a11, a12, a22, b1, b2), du / dv
    None meaning zero. `rows`: the strip windows' places, or None."""
    ref = p.ref
    zero_duv = p.niter_inner == 1

    if route.assembly == "merged":
        def derive(wxc, wyc):
            return wxc, wyc

        def occ_costs(state):
            return warp_assemble(seq, *state, None, None, None, channel_w, p,
                                 mode="occ", zero_duv=True, rows=rows)

        def data_terms(state, du, dv, occ):
            return warp_assemble(seq, *state, occ, du, dv, channel_w, p,
                                 mode="assembly",
                                 zero_duv=zero_duv or du is None, rows=rows)
    elif route.assembly == "stack":
        def derive(wxc, wyc):
            warped, masks = warp_stack(seq, wxc, wyc, ref, rows)
            return warped, succ_mask(masks, ref)

        def occ_costs(state):
            return fused_data_system(*state, None, None, channel_w, p,
                                     mode="occ", zero_duv=True)

        def data_terms(state, du, dv, occ):
            warped, mask = state
            return fused_data_system(warped, gate_masks(mask, occ, p), du, dv,
                                     channel_w, p, mode="assembly",
                                     zero_duv=zero_duv or du is None)
    else:
        warp = _window_warp_pallas if p.pallas_warp else warp_stack

        def derive(wxc, wyc):
            return get_derivatives_mt(
                seq, wxc, wyc, ref,
                warp=lambda *a: warp(*a, rows=rows))

        def occ_costs(state):
            succ, to_ref, mask = state
            return occlusion_data_costs(mask, succ, to_ref, p)

        def data_terms(state, du, dv, occ):
            succ, to_ref, mask = state
            if du is None:
                du = dv = torch.zeros_like(occ)
            return add_data_terms(du, dv, gate_masks(mask, occ, p), succ,
                                  to_ref, channel_w, p)
    return derive, occ_costs, data_terms


def compute_one_level(wx, wy, seq, channel_w, norm_avg, norm_std,
                      p: MultiFrameParams, strips=None):
    """Alternating discrete / continuous minimization at one pyramid level.

    wx, wy [B, H, W]; seq [B, 2ref+1, 3, H, W]; channel_w [B, 3, H, W];
    norm_avg, norm_std [B, 3]. Returns (wx, wy, occlusions in {-1, 0, +1}).
    `strips` (parallel/strips.py `Strips`): the batch is this device's strip
    windows (module docstring); the result is those windows."""
    ref = p.ref
    b, _, _, h, w = seq.shape
    hw = h * w if strips is None else strips.img_h * w
    dev = seq.device
    route = p.route()
    _, _, reg_pen = p.penalties()
    dn = data_norm(p)
    occ_step = p.occlusion_reasoning and not p.one_direction
    fuse_occ = route.fuse_occ and p.niter_outer >= 1
    occ = torch.full_like(wx, -1.0) \
        if (p.one_direction or p.occlusion_reasoning) else torch.zeros_like(wx)
    dpsis = compute_dpsis_weight_mt(seq[:, ref], norm_avg, norm_std, 5.0,
                                    p.hbit)
    inf = torch.full((b,), float("inf"), device=dev)
    rows = None if strips is None else strips.rows
    derive, occ_costs, data_terms = _level_state(route, seq, channel_w, p,
                                                 rows)

    def any_live(live):
        return bool(live.any()) if strips is None else strips.any(live)

    def entry_sum(x):
        """Sums of [B, H, W] planes per batch entry (a strip window's own
        rows)."""
        return x.sum((1, 2)) if strips is None else strips.own_sum(x)

    def image_sum(x):
        """Sums of [B, H, W] planes per jet, over its whole image."""
        return entry_sum(x) if strips is None \
            else strips.jet_sum(entry_sum(x))

    def cover(wx, wy, occ):
        """With strips, widen every window that the warp by wy outgrows."""
        nonlocal seq, channel_w, dpsis, rows, derive, occ_costs, data_terms
        if strips is None:
            return wx, wy, occ
        wider = strips.cover(wy, seq, channel_w, wx, wy, occ)
        if wider is None:
            return wx, wy, occ
        seq, channel_w, wx, wy, occ = wider
        rows = strips.rows
        dpsis = compute_dpsis_weight_mt(seq[:, ref], norm_avg, norm_std, 5.0,
                                        p.hbit)
        derive, occ_costs, data_terms = _level_state(route, seq, channel_w,
                                                     p, rows)
        return wx, wy, occ

    def solve(uu, vv, du, dv, system):
        """(ndu, ndv, sums [B, 2] of |ndu - du|, |ndv - dv|); du / dv None
        means the sweeps start from zero. With strips the ghost rows of
        ndu / ndv are refreshed and the sums are the jets'."""
        if route.solve == "fused":
            ndu, ndv, sums = solve_step(
                uu, vv, dpsis, *system, du, dv, alpha=p.alpha,
                reg_pen=reg_pen, method=p.smoothing,
                iterations=p.niter_solver, omega=p.sor_omega,
                with_change=True, rows=rows)
        else:
            a11, a12, a22, b1, b2 = system
            wh, wv = compute_smoothness_mt(uu, vv, dpsis, p.alpha, reg_pen,
                                           p.smoothing)
            b1 = sub_laplacian(b1, uu, wh, wv)
            b2 = sub_laplacian(b2, vv, wh, wv)
            du0 = torch.zeros_like(uu) if du is None else du
            dv0 = torch.zeros_like(vv) if dv is None else dv
            ndu, ndv = sor_coupled_rb_pallas(
                du0, dv0, a11, a12, a22, b1, b2, wh, wv,
                iterations=p.niter_solver, omega=p.sor_omega, rows=rows)
            sums = torch.stack([entry_sum((ndu - du0).abs()),
                                entry_sum((ndv - dv0).abs())], -1)
        if strips is not None:
            strips.exchange(ndu, ndv)
            sums = strips.jet_sum(sums)
        return ndu, ndv, sums

    def rate(sums):
        return torch.maximum(sums[:, 0], sums[:, 1]) / hw

    def inner(wx0, wy0, state, occ, live):
        """IRLS increments at the linearization point (wx0, wy0), whose
        state is `state`. Returns (uu, vv, change of the last increment)."""
        du = dv = None
        uu, vv, change = wx0, wy0, inf
        for it in range(p.niter_inner):
            if it > 0 and not any_live(live):
                break
            system = data_terms(state, du, dv, occ)
            ndu, ndv, sums = solve(uu, vv, du, dv, system)
            du = ndu if du is None else _freeze(live, ndu, du)
            dv = ndv if dv is None else _freeze(live, ndv, dv)
            uu = _freeze(live, wx0 + ndu, uu)
            vv = _freeze(live, wy0 + ndv, vv)
            change = torch.where(live, rate(sums), change)
            live = live & (change >= p.thres_inner)
        return uu, vv, change

    def outer(wx, wy, occ, live, state, first_system):
        """Re-warp / re-linearize loop from the alternation-top `state`.
        first_system: the already assembled iteration-0 system (fused
        occlusion route), solved from zero. Returns (wx, wy, occ, change):
        with strips a widening replaces occ's windows too."""
        change = inf
        start = 0
        if first_system is not None:
            ndu, ndv, sums = solve(wx, wy, None, None, first_system)
            wx = _freeze(live, wx + ndu, wx)
            wy = _freeze(live, wy + ndv, wy)
            change = torch.where(live, rate(sums), change)
            live = live & (change >= p.thres_outer)
            start = 1
        for it in range(start, p.niter_outer):
            if not any_live(live):
                break
            if it > 0:
                wx, wy, occ = cover(wx, wy, occ)
                state = derive(wx, wy)
            uu, vv, ch = inner(wx, wy, state, occ, live)
            if p.niter_inner != 1:
                ch = torch.maximum(image_sum((uu - wx).abs()),
                                   image_sum((vv - wy).abs())) / hw
            wx = _freeze(live, uu, wx)
            wy = _freeze(live, vv, wy)
            change = torch.where(live, ch, change)
            live = live & (change >= p.thres_outer)
        return wx, wy, occ, change

    def relabel(e0, e1):
        lab = solve_binary_potts(e0, e1, p.occlusion_alpha, p.niter_graphc,
                                 strips)
        occ = 2.0 * lab - 1.0
        if strips is not None:
            strips.exchange(occ)
        return occ

    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for it in range(p.niter_alter):
        if it > 0 and not any_live(alive):
            break
        wx, wy, occ = cover(wx, wy, occ)
        state = derive(wx, wy)
        first_system = None
        new_occ = occ
        stable = torch.ones(b, dtype=torch.bool, device=dev)
        if fuse_occ:
            outs = warp_assemble(seq, wx, wy, None, None, None, channel_w, p,
                                 mode="occ_assembly", zero_duv=True,
                                 rows=rows)
            if it > 0:
                new_occ = relabel(outs[0], outs[1])
            backward, forward = direction_weights(new_occ, dn)
            first_system = tuple(backward * sb + forward * sf for sb, sf
                                 in zip(outs[2:7], outs[7:12]))
        elif occ_step and it > 0:
            new_occ = relabel(*occ_costs(state))
        if occ_step:
            stable = image_sum((new_occ != occ).float()) == 0 if it > 0 \
                else torch.zeros_like(stable)
        occ = _freeze(alive, new_occ, occ)
        wx, wy, occ, change = outer(wx, wy, occ, alive, state, first_system)
        # fixed-point exit: labels repeat and the flow moved below thres
        alive = alive & ~(stable & (change < p.thres_outer))
    return wx, wy, occ


def _mt_pipeline(wx, wy, seq, channel_w, norm_avg, norm_std,
                 p: MultiFrameParams):
    """Pyramid, then coarse to fine: per level the alternating solve, then
    the flow upscaled to the next level."""
    _, _, _, h, w = seq.shape
    sizes = pyramid_sizes(h, w, p.layers, p.p_scale)
    pyr = build_pyramid(seq, sizes, p.p_scale, sigma0=p.sigma)
    cw_pyr = build_pyramid(channel_w, sizes, p.p_scale) \
        if p.layers > 1 else [channel_w]
    n_levels = len(sizes)
    if n_levels > 1:
        wx, wy = rescale_flow(wx, wy, *sizes[-1])
    occ = None
    for level in range(n_levels - 1, -1, -1):
        if level < n_levels - 1:
            wx, wy = rescale_flow(wx, wy, *sizes[level])
        wx, wy, occ = compute_one_level(
            wx, wy, pyr[level], cw_pyr[level] if p.layers > 1 else channel_w,
            norm_avg, norm_std, p)
    return wx, wy, occ


def variational_mt_batched(wx, wy, seq, p: MultiFrameParams, channel_w=None,
                           norm_avg=None, norm_std=None, *, device=None):
    """Jet-batched multi-frame minimization.

    wx, wy [B, H, W]; seq [B, 2ref+1, 3, H, W] normalized windows (numpy
    arrays or tensors); channel_w [B, 3, H, W]; norm_avg / norm_std [B, 3].
    `device`: None = the device of `seq` if it is a tensor, else CUDA (which
    raises when torch finds no GPU); the CPU only when asked for, by
    `device="cpu"` or CPU tensors. Returns (wx, wy, occlusions) [B, H, W]
    tensors on that device."""
    device = device_of(seq, device)
    seq = as_f32(seq, device)
    wx = as_f32(wx, device)
    wy = as_f32(wy, device)
    b, f, _, h, w = seq.shape
    if f != 2 * p.ref + 1:
        raise ValueError(f"window of {f} frames does not match S = {p.S}")
    channel_w, norm_avg, norm_std = _default_terms(
        b, h, w, channel_w, norm_avg, norm_std, device)
    with on_device(device):
        return _mt_pipeline(wx, wy, seq, channel_w, norm_avg, norm_std, p)


def _default_terms(b, h, w, channel_w, norm_avg, norm_std, device):
    """channel_w [b, 3, h, w], norm_avg / norm_std [b, 3] on `device`; None
    means ones, zeros and ones."""
    channel_w = torch.ones((b, 3, h, w), device=device) if channel_w is None \
        else as_f32(channel_w, device)
    norm_avg = torch.zeros((b, 3), device=device) if norm_avg is None \
        else as_f32(norm_avg, device)
    norm_std = torch.ones((b, 3), device=device) if norm_std is None \
        else as_f32(norm_std, device)
    return channel_w, norm_avg, norm_std


def variational_mt_sharded(wx, wy, seq, p: MultiFrameParams, mesh,
                           channel_w=None, norm_avg=None, norm_std=None):
    """`variational_mt_batched` with the jet batch split over the devices
    of `mesh` (`parallel.mesh.make_mesh`): each device's contiguous chunk
    runs `_mt_pipeline` on a host thread of its own (on CUDA inside
    `torch.cuda.device(d)`, on a stream of its own), with the kernels as in
    the batched call; jets share nothing, so only the placement differs.
    The batch must divide evenly over the mesh. Inputs as for
    `variational_mt_batched`; returns (wx, wy, occlusions) [B, H, W] on the
    mesh's first device."""
    if getattr(mesh, "n_sp", 1) != 1:
        raise ValueError("variational_mt_sharded splits jets only (a mesh of "
                         "sp extent 1); sharded_jet_step runs one level over "
                         "sp")
    mesh = make_mesh(devices=mesh)
    device = mesh[0]
    seq = as_f32(seq, device)
    b, f, _, h, w = seq.shape
    if f != 2 * p.ref + 1:
        raise ValueError(f"window of {f} frames does not match S = {p.S}")
    if b % len(mesh):
        raise ValueError(f"batch of {b} jets does not split evenly over "
                         f"{len(mesh)} devices")
    channel_w, norm_avg, norm_std = _default_terms(
        b, h, w, channel_w, norm_avg, norm_std, device)
    return run_sharded(mesh, lambda *a: _mt_pipeline(*a, p),
                       as_f32(wx, device), as_f32(wy, device), seq,
                       channel_w, norm_avg, norm_std)


def variational_mt(wx, wy, seq, p: MultiFrameParams, channel_w=None,
                   norm_avg=None, norm_std=None, *, device=None):
    """Single window: seq [2ref+1, 3, H, W], flow [H, W]. Returns
    (wx, wy, occlusions) [H, W]."""
    def one(x):
        return None if x is None else (x[None] if isinstance(x, torch.Tensor)
                                       else np.asarray(x)[None])

    out = variational_mt_batched(one(wx), one(wy), one(seq), p,
                                 one(channel_w), one(norm_avg), one(norm_std),
                                 device=device)
    return tuple(o[0] for o in out)
