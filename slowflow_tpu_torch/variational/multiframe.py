"""Multi-frame, occlusion-aware variational flow: the stage-2 jet solve
(torch port of `slowflow_tpu.variational.multiframe`).

Jets are a batch axis, not a loop. Each loop level keeps a per-jet `live`
flag on the device; a jet that has converged keeps its state (torch.where),
which reproduces the per-jet exits of the JAX package's unrolled jets. The
loop-exit tests read `live.any()` on the host once per iteration.

A level is cut into segments that read nothing on the host (`_Level`):
the start, the alternation top, one outer iteration, one further inner
iteration, the outer tail, the alternation end; the host loop reads the
exit flags between them. On CUDA each segment replays a cached CUDA graph
(variational/graphs.py), the counterpart of the JAX package's jit: the same
kernels in the same order, bitwise the eager level. With strips each window
geometry has its own graphs (`_GraphedStrips`), and the collectives between
devices run on the host between a segment's captured parts.

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
when the flow outgrows them (`_Level.widen`). Without one every hook is
skipped.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from ..core.image import build_pyramid, pyramid_sizes, rescale_flow
from ..core.solver_pallas import sor_coupled_rb_pallas
from ..core.warp_pallas import warp_stack_pallas
from ..core.warp_shift import warp_stack
from ..parallel.mesh import make_mesh, run_sharded
from ..runtime import as_f32, device_of, on_device
from ..utils.phases import call, span
from . import graphs
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


class _Level(graphs.Segments):
    """One pyramid level's alternating solve (`compute_one_level`) over a
    state namespace `st`, cut into segments that read nothing on the host,
    and the host loop that runs them and reads the exit flags between them
    (`drive`).

    `st` holds the flow wx, wy and labels occ [B, H, W], dpsis, per-jet
    alive (alternation), live (outer) and ilive (inner) flags, change /
    ichange, stable, the route's derived state (not on the merged route,
    whose state is the flow), and the inner loop's du, dv, uu, vv. Each
    segment ends by marking the flag that the next host read tests. Eagerly
    `st` is a plain namespace and the read is `live.any()` (over a jet's
    strips with `strips`); in a graph program (variational/graphs.py) `st`
    is that program's Slots, a segment writes `flag` = live.any() and the
    host reads it between replays, and the ICM runs its sweeps with no
    per-sweep read. With strips the host read ORs the flag over every
    rank."""

    def __init__(self, seq, channel_w, norm_avg, norm_std,
                 p: MultiFrameParams, strips=None, st=None):
        super().__init__(SimpleNamespace() if st is None else st,
                         st is not None)
        self.p = p
        self.route = p.route()
        self.seq, self.channel_w = seq, channel_w
        self.norm_avg, self.norm_std = norm_avg, norm_std
        self.strips = strips
        self.rows = None if strips is None else strips.rows
        b, _, _, h, w = seq.shape
        self.b = b
        self.hw = h * w if strips is None else strips.img_h * w
        _, _, self.reg_pen = p.penalties()
        self.dn = data_norm(p)
        self.occ_step = p.occlusion_reasoning and not p.one_direction
        self.fuse_occ = first_system(p)
        self._bind()

    def _bind(self):
        self.derive, self.occ_costs, self.data_terms = _level_state(
            self.route, self.seq, self.channel_w, self.p, self.rows)

    def _dpsis(self):
        return compute_dpsis_weight_mt(self.seq[:, self.p.ref], self.norm_avg,
                                       self.norm_std, 5.0, self.p.hbit)

    def _inf(self):
        return torch.full((self.b,), float("inf"), device=self.seq.device)

    def _derive(self):
        if self.route.assembly != "merged":
            self.st.state = self.derive(self.st.wx, self.st.wy)

    def _state(self):
        """The derived state at the current linearization point."""
        st = self.st
        return (st.wx, st.wy) if self.route.assembly == "merged" \
            else st.state

    # ------------------------------------------------------ host reads
    def read(self) -> bool:
        """Whether any jet of the last marked flag is live (over every
        rank's strips with `strips`)."""
        if self.strips is None:
            return super().read()
        return call("graph.flag_read", self.strips.any,
                    self.st.flag if self.graphed else self.marked)

    # ---------------------------------------------------------- helpers
    def entry_sum(self, x):
        """Sums of [B, H, W] planes per batch entry (a strip window's own
        rows)."""
        return x.sum((1, 2)) if self.strips is None \
            else self.strips.own_sum(x)

    def image_sum(self, x):
        """Sums of [B, H, W] planes per jet, over its whole image."""
        return self.entry_sum(x) if self.strips is None \
            else self.strips.jet_sum(self.entry_sum(x))

    def cover(self):
        """With strips, widen every window that the warp by wy outgrows."""
        strips, st = self.strips, self.st
        if strips is None:
            return
        wider = strips.cover(st.wy, self.seq, self.channel_w, st.wx, st.wy,
                             st.occ)
        if wider is not None:
            self.widen(*wider)

    def widen(self, ts, geometry):
        """Go on in the wider windows of `geometry`; ts = (seq, channel_w,
        wx, wy, occ) widened."""
        st = self.st
        self.strips = strips = self.strips.widened(geometry)
        self.rows = strips.rows
        self.seq, self.channel_w, st.wx, st.wy, st.occ = ts
        st.dpsis = self._dpsis()
        self._bind()

    def solve(self, uu, vv, du, dv, system):
        """(ndu, ndv, sums [B, 2] of |ndu - du|, |ndv - dv|); du / dv None
        means the sweeps start from zero. With strips the ghost rows of
        ndu / ndv are refreshed and the sums are the jets'."""
        p, rows = self.p, self.rows
        if self.route.solve == "fused":
            ndu, ndv, sums = solve_step(
                uu, vv, self.st.dpsis, *system, du, dv, alpha=p.alpha,
                reg_pen=self.reg_pen, method=p.smoothing,
                iterations=p.niter_solver, omega=p.sor_omega,
                with_change=True, rows=rows)
        else:
            a11, a12, a22, b1, b2 = system
            wh, wv = compute_smoothness_mt(uu, vv, self.st.dpsis, p.alpha,
                                           self.reg_pen, p.smoothing)
            b1 = sub_laplacian(b1, uu, wh, wv)
            b2 = sub_laplacian(b2, vv, wh, wv)
            du0 = torch.zeros_like(uu) if du is None else du
            dv0 = torch.zeros_like(vv) if dv is None else dv
            ndu, ndv = sor_coupled_rb_pallas(
                du0, dv0, a11, a12, a22, b1, b2, wh, wv,
                iterations=p.niter_solver, omega=p.sor_omega, rows=rows)
            sums = torch.stack([self.entry_sum((ndu - du0).abs()),
                                self.entry_sum((ndv - dv0).abs())], -1)
        if self.strips is not None:
            self.strips.exchange(ndu, ndv)
            sums = self.strips.jet_sum(sums)
        return ndu, ndv, sums

    def rate(self, sums):
        return torch.maximum(sums[:, 0], sums[:, 1]) / self.hw

    def relabel(self, e0, e1):
        lab = solve_binary_potts(e0, e1, self.p.occlusion_alpha,
                                 self.p.niter_graphc, self.strips,
                                 early_exit=not self.graphed)
        occ = 2.0 * lab - 1.0
        if self.strips is not None:
            self.strips.exchange(occ)
        return occ

    # --------------------------------------------------------- segments
    def start(self):
        """Labels, dpsis and alive for a level whose st.wx / st.wy are
        set."""
        st, p = self.st, self.p
        st.occ = torch.full_like(st.wx, -1.0) \
            if (p.one_direction or p.occlusion_reasoning) \
            else torch.zeros_like(st.wx)
        st.dpsis = self._dpsis()
        st.alive = torch.ones(self.b, dtype=torch.bool,
                              device=self.seq.device)

    def top(self, later: bool):
        """The alternation top: the state, the relabel (from the second
        alternation on) and, on the fused-occlusion route, the first outer
        iteration's system solved from zero."""
        st, p = self.st, self.p
        self._derive()
        first = None
        new_occ = st.occ
        if self.fuse_occ:
            outs = warp_assemble(self.seq, st.wx, st.wy, None, None, None,
                                 self.channel_w, p, mode="occ_assembly",
                                 zero_duv=True, rows=self.rows)
            if later:
                new_occ = self.relabel(outs[0], outs[1])
            backward, forward = direction_weights(new_occ, self.dn)
            first = tuple(backward * sb + forward * sf for sb, sf
                          in zip(outs[2:7], outs[7:12]))
        elif self.occ_step and later:
            new_occ = self.relabel(*self.occ_costs(self._state()))
        stable = torch.ones(self.b, dtype=torch.bool, device=self.seq.device)
        if self.occ_step:
            stable = self.image_sum((new_occ != st.occ).float()) == 0 \
                if later else torch.zeros_like(stable)
        st.stable = stable
        st.occ = _freeze(st.alive, new_occ, st.occ)
        live, change = st.alive, self._inf()
        if first is not None:
            ndu, ndv, sums = self.solve(st.wx, st.wy, None, None, first)
            st.wx = _freeze(live, st.wx + ndu, st.wx)
            st.wy = _freeze(live, st.wy + ndv, st.wy)
            change = torch.where(live, self.rate(sums), change)
            live = live & (change >= p.thres_outer)
        st.change = change
        st.live = live
        self.mark(live)

    def outer(self, later: bool):
        """One outer iteration: the state again after the first, then the
        first inner iteration (IRLS increments from zero); with one inner
        iteration also the outer update."""
        st, p = self.st, self.p
        if later:
            self._derive()
        live = st.live
        system = self.data_terms(self._state(), None, None, st.occ)
        ndu, ndv, sums = self.solve(st.wx, st.wy, None, None, system)
        uu = _freeze(live, st.wx + ndu, st.wx)
        vv = _freeze(live, st.wy + ndv, st.wy)
        ichange = torch.where(live, self.rate(sums), self._inf())
        if p.niter_inner == 1:
            self._outer_update(uu, vv, ichange)
            return
        st.du, st.dv, st.uu, st.vv, st.ichange = ndu, ndv, uu, vv, ichange
        st.ilive = live & (ichange >= p.thres_inner)
        self.mark(st.ilive)

    def inner(self):
        """One further inner iteration at the outer linearization point."""
        st, p = self.st, self.p
        ilive = st.ilive
        system = self.data_terms(self._state(), st.du, st.dv, st.occ)
        ndu, ndv, sums = self.solve(st.uu, st.vv, st.du, st.dv, system)
        st.du = _freeze(ilive, ndu, st.du)
        st.dv = _freeze(ilive, ndv, st.dv)
        st.uu = _freeze(ilive, st.wx + ndu, st.uu)
        st.vv = _freeze(ilive, st.wy + ndv, st.vv)
        st.ichange = torch.where(ilive, self.rate(sums), st.ichange)
        st.ilive = ilive & (st.ichange >= p.thres_inner)
        self.mark(st.ilive)

    def tail(self):
        """The outer update after several inner iterations."""
        self._outer_update(self.st.uu, self.st.vv, None)

    def _outer_update(self, uu, vv, ch):
        st, p = self.st, self.p
        live = st.live
        if p.niter_inner != 1:
            ch = torch.maximum(self.image_sum((uu - st.wx).abs()),
                               self.image_sum((vv - st.wy).abs())) / self.hw
        st.wx = _freeze(live, uu, st.wx)
        st.wy = _freeze(live, vv, st.wy)
        st.change = torch.where(live, ch, st.change)
        st.live = live & (st.change >= p.thres_outer)
        self.mark(st.live)

    def end(self):
        """Fixed-point exit: labels repeat and the flow moved below thres."""
        st = self.st
        st.alive = st.alive & ~(st.stable & (st.change < self.p.thres_outer))
        self.mark(st.alive)

    # --------------------------------------------------------- the loop
    def drive(self, run):
        """The level's host loop: each segment through run(segment, fn),
        the exit flags read between them where the loops test them."""
        p = self.p
        run(("start",), self.start)
        for it in range(p.niter_alter):
            if it > 0 and not self.read():
                break
            self.cover()
            run(("top", it > 0), lambda: self.top(it > 0))
            for oit in range(1 if self.fuse_occ else 0, p.niter_outer):
                if not self.read():
                    break
                if oit > 0:
                    self.cover()
                run(("outer", oit > 0), lambda: self.outer(oit > 0))
                if p.niter_inner > 1:
                    for _ in range(1, p.niter_inner):
                        if not self.read():
                            break
                        run(("inner",), self.inner)
                    run(("tail",), self.tail)
            run(("end",), self.end)


class _GraphedStrips(_Level):
    """A level with strips in its graph form. Each window geometry has its
    Program (`graphs.running` under `graphs.level_key` and `Strips.key`),
    which keeps the Strips whose tables its graphs read. A widening moves
    the level into the Program of the wider windows: the widened inputs,
    flow and labels, dpsis on them, and the per-jet state that later
    segments read before they write it, copied into its Slots."""

    CARRY = ("alive", "live", "change", "stable")

    def __init__(self, seq, channel_w, norm_avg, norm_std,
                 p: MultiFrameParams, strips, programs):
        self.programs = programs    # an ExitStack that enters each Program
        # the strips come with the first Program (`_enter`): a kept Strips
        # stands in for `strips`, whose device tables are then never made
        super().__init__(seq, channel_w, norm_avg, norm_std, p,
                         st=graphs.Slots())
        self._enter(strips, seq, channel_w, {})

    def _enter(self, strips, seq, channel_w, carry):
        b, _, _, h, w = seq.shape
        self.hw = strips.img_h * w
        key = graphs.level_key(seq.device, self.p, b, h, w,
                               self.fuse_occ) + strips.key()
        prog = self.programs.enter_context(
            graphs.running(key, seq.device, graphed=True))
        if prog.keep is None:
            prog.keep = strips
        else:
            strips = prog.keep.rejoin(strips.plan)
        ins = prog.inputs
        ins.seq, ins.channel_w = seq, channel_w
        ins.norm_avg, ins.norm_std = self.norm_avg, self.norm_std
        for name, value in carry.items():
            setattr(prog.state, name, value)
        self.prog, self.st = prog, prog.state
        self.strips, self.rows = strips, strips.rows
        self.seq, self.channel_w = ins.seq, ins.channel_w
        self.norm_avg, self.norm_std = ins.norm_avg, ins.norm_std
        self._bind()

    def widen(self, ts, geometry):
        seq, channel_w, wx, wy, occ = ts
        carry = {k: getattr(self.st, k) for k in self.CARRY
                 if hasattr(self.st, k)}
        self._enter(self.strips.widened(geometry), seq, channel_w,
                    dict(carry, wx=wx, wy=wy, occ=occ))
        self.st.dpsis = self._dpsis()

    def run(self, segment, fn) -> None:
        self.prog.run(segment, fn)


def _graphed_strip_level(wx, wy, seq, channel_w, norm_avg, norm_std,
                         p: MultiFrameParams, strips):
    """`compute_one_level` with strips in its graph form."""
    with contextlib.ExitStack() as programs:
        level = _GraphedStrips(seq, channel_w, norm_avg, norm_std, p, strips,
                               programs)
        level.st.wx, level.st.wy = wx, wy
        level.drive(level.run)
        st = level.st
        return st.wx.clone(), st.wy.clone(), st.occ.clone()


def first_system(p: MultiFrameParams) -> bool:
    """Whether the alternation top assembles and solves the first outer
    iteration's system (the fused-occlusion route)."""
    return p.route().fuse_occ and p.niter_outer >= 1


def compute_one_level(wx, wy, seq, channel_w, norm_avg, norm_std,
                      p: MultiFrameParams, strips=None, *, _eager=False):
    """Alternating discrete / continuous minimization at one pyramid level.

    wx, wy [B, H, W]; seq [B, 2ref+1, 3, H, W]; channel_w [B, 3, H, W];
    norm_avg, norm_std [B, 3]. Returns (wx, wy, occlusions in {-1, 0, +1}).
    `strips` (parallel/strips.py `Strips`): the batch is this device's strip
    windows (module docstring); the result is those windows.

    On CUDA the level replays this thread's cached CUDA graphs of its
    segments (variational/graphs.py; with strips, those of each window
    geometry), bitwise equal to the eager level; on the CPU it runs
    eagerly. `_eager` (for tests and chip_smoke.py only) runs a CUDA level
    eagerly."""
    if _eager or seq.device.type != "cuda":
        level = _Level(seq, channel_w, norm_avg, norm_std, p, strips)
        level.st.wx, level.st.wy = wx, wy
        level.drive(lambda segment, fn: fn())
        return level.st.wx, level.st.wy, level.st.occ
    if strips is not None:
        return _graphed_strip_level(wx, wy, seq, channel_w, norm_avg,
                                    norm_std, p, strips)
    b, _, _, h, w = seq.shape
    key = graphs.level_key(seq.device, p, b, h, w, first_system(p))
    with graphs.running(key, seq.device, graphed=True) as prog:
        ins = prog.inputs
        ins.seq, ins.channel_w = seq, channel_w
        ins.norm_avg, ins.norm_std = norm_avg, norm_std
        if prog.level is None:
            prog.level = _Level(ins.seq, ins.channel_w, ins.norm_avg,
                                ins.norm_std, p, st=prog.state)
        st = prog.state
        st.wx, st.wy = wx, wy
        prog.level.drive(prog.run)
        return st.wx.clone(), st.wy.clone(), st.occ.clone()


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
    with span("sf.call"):
        seq = as_f32(seq, device)
        wx = as_f32(wx, device)
        wy = as_f32(wy, device)
        b, f, _, h, w = seq.shape
        if f != 2 * p.ref + 1:
            raise ValueError(f"window of {f} frames does not match "
                             f"S = {p.S}")
        channel_w, norm_avg, norm_std = _default_terms(
            b, h, w, channel_w, norm_avg, norm_std, device)
        with on_device(device):
            return _mt_pipeline(wx, wy, seq, channel_w, norm_avg, norm_std,
                                p)


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
