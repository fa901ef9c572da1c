"""Dense tracking driver, stage 3 of the pipeline (torch port of
`slowflow_tpu.tracking.driver`; the reference is dense_tracking.cpp:415-1977).

Per final frame pair: load the jet estimations at one or more frame rates,
build trajectory hypotheses (consistent accumulations + EPIC-interpolated),
then alternate between neighbour-proposal propagation, non-maximum
suppression, and multi-label MRF selection (TRW / BP), giving the final
reference flow and occlusion map. On CUDA the alternation runs as cached
CUDA graphs of its segments (`_Alternation`), as the JAX package runs it
as jitted programs.

The hypothesis bank is a dict of fixed-capacity tensors with a leading
final-pair axis, [F, h, w, K, ...]: F final pairs of one shape advance
through the alternations side by side, and `track_final_pair` is the F = 1
case of the same code. The reference's FLANN KD-tree proposals are seeded
stratified offsets over the consistent-pixel lattice; their random draws
come from one source, `draws(p_it, t, ntry, h, w) -> (ang, u)`, shared by
every final pair of a batch so that batched and serial runs agree.
"""
from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..config import ParameterList
from ..core.penalty import make_penalty
from ..runtime import as_f32, resolve_device
from ..utils.phases import phase, span
from ..variational import graphs
from .accumulate import accumulate_consistent_batches
from .hypothesis import (
    EnergyParams, adapt_fps, hypothesis_energy, set_occlusions,
    trajectory_distance, UNKNOWN,
)
from .mrf import BIG, pairwise_costs, solve_multilabel


@dataclass
class TrackingConfig:
    """All acc_* knobs (defaults: dense_tracking.cpp:118-166 + cfg)."""

    jets: int
    rates: int
    skip_pixel: int = 1
    consistency_threshold: float = 1.0
    discard_inconsistent: bool = False
    use_jet_occlusions: bool = False
    epic_interpolation: bool = True
    epic_skip: int = 2
    acc_jc: float = 1.0
    acc_bc: float = 0.1
    acc_gc: float = 1.0
    acc_occ: float = 500.0
    acc_beta: float = 10.0
    acc_spatial_occ: float = 10.0
    acc_cv: float = 0.0
    acc_temporal_occ: float = 10.0
    occlusion_threshold: float = 5.0
    occlusion_fb_threshold: float = 5.0
    alternate: int = 5
    approach: int = 0               # 0: TRW, 1: BP
    trws_eps: float = 1e-5
    trws_max_iter: int = 10
    neigh_hyp: int = 5
    neigh_hyp_radius: float = 100.0
    hyp_neigh_tryouts: int = 20
    nn_skip1: int = 2
    nn_skip2: int = 4
    perturb_keep: int = 0
    traj_sim_method: int = 1        # 0 ADJ, 1 ACC, 2 FINAL
    traj_sim_thres: float = 0.1
    penalty_fct_data: int = 1
    penalty_fct_data_eps: float = 0.001
    penalty_fct_reg: int = 1
    penalty_fct_reg_eps: float = 0.001
    seed: int = 0
    capacity: int = 16

    @classmethod
    def from_parameter_list(cls, params: ParameterList, jets: int, rates: int):
        g = params.parameter
        return cls(
            jets=jets, rates=rates,
            skip_pixel=g("acc_skip_pixel", "0", int),
            consistency_threshold=g("acc_consistency_threshold", "1.0", float),
            discard_inconsistent=g("acc_discard_inconsistent", "0", bool),
            use_jet_occlusions=g("acc_occlusion", "0", bool)
            or g("acc_use_jet_occlusions", "0", bool),
            epic_interpolation=g("acc_epic_interpolation", "1", bool),
            epic_skip=int(g("acc_epic_skip", "2", float)),
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
            nn_skip1=g("acc_neigh_skip1", "2", int),
            nn_skip2=g("acc_neigh_skip2", "4", int),
            perturb_keep=g("acc_perturb_keep", "0", int),
            traj_sim_method=g("acc_traj_sim_method", "1", int),
            traj_sim_thres=g("acc_traj_sim_thres", "0.1", float),
            penalty_fct_data=g("acc_penalty_fct_data", "1", int),
            penalty_fct_data_eps=g("acc_penalty_fct_data_eps", "0.001", float),
            penalty_fct_reg=g("acc_penalty_fct_reg", "1", int),
            penalty_fct_reg_eps=g("acc_penalty_fct_reg_eps", "0.001", float),
            seed=g("seed", "0", int),
            capacity=g("acc_capacity", "16", int),
        )

    def energy_params(self) -> EnergyParams:
        return EnergyParams(
            acc_jc=self.acc_jc, acc_bc=self.acc_bc, acc_gc=self.acc_gc,
            acc_occ=self.acc_occ, acc_cv=self.acc_cv,
            acc_temporal_occ=self.acc_temporal_occ,
            skip_pixel=self.skip_pixel)


def draw_seed(seed: int, p_it: int, t: int) -> int:
    """The generator seed of propagation pass `p_it`, lattice stride `t`."""
    return (int(seed) * 65536 + int(p_it)) * 16 + int(t)


def default_draws(seed: int, device):
    """The propagation pass's source of draws: for pass `p_it` and stride
    `t`, a `torch.Generator` on `device` seeded by `draw_seed(seed, p_it,
    t)` gives ang = 2*pi*U and u = U' (U, U' uniform on [0, 1), shape
    [ntry, h, w])."""
    device = torch.device(device)

    def draws(p_it, t, ntry, h, w):
        gen = torch.Generator(device=device)
        gen.manual_seed(draw_seed(seed, p_it, t))
        ang = torch.rand((ntry, h, w), generator=gen, device=device) \
            * (2 * np.pi)
        u = torch.rand((ntry, h, w), generator=gen, device=device)
        return ang, u

    return draws


def _sync(device):
    if device.type == "cuda":
        graphs.synchronize(device)


def _grid_positions(h, w, xy_incr, xy_start, device):
    """px, py [h, w, 1] of the subsampled grid at the original resolution."""
    px = (torch.arange(w, dtype=torch.float32, device=device) * xy_incr
          + xy_start)[None, :, None]
    py = (torch.arange(h, dtype=torch.float32, device=device) * xy_incr
          + xy_start)[:, None, None]
    return px.expand(h, w, 1), py.expand(h, w, 1)


def _occ_tensor(occlusions, device):
    """Jet occlusion maps -> uint8 tensor on `device`, or None."""
    if occlusions is None:
        return None
    if isinstance(occlusions, torch.Tensor):
        return occlusions.to(device)
    return torch.as_tensor(np.ascontiguousarray(occlusions), device=device)


# --------------------------------------------------------------------------
# the hypothesis bank, [F, h, w, K, ...]
# --------------------------------------------------------------------------
# The reference stores per-pixel vectors of heap-allocated `hypothesis`
# objects (dense_tracking.cpp:690-724); here the bank stays on the device
# for the whole alternation.
def _new_bank(f, h, w, K, J, device):
    return dict(
        flows=torch.full((f, h, w, K, J, 2), UNKNOWN, device=device),
        occl=torch.zeros((f, h, w, K, J + 1), dtype=torch.int32,
                         device=device),
        energy=torch.full((f, h, w, K), float("inf"), device=device),
        valid=torch.zeros((f, h, w, K), dtype=torch.bool, device=device),
        jet_est=torch.zeros((f, h, w, K), dtype=torch.int32, device=device),
    )


def _bank_insert(bank, flows, occl, energy, jet_est, mask):
    """Insert one hypothesis per pixel into the first free slot.
    flows [F, h, w, J, 2]; mask [F, h, w]. Returns (bank, inserted)."""
    K = bank["energy"].shape[-1]
    free = ~bank["valid"]
    first_free = free.to(torch.uint8).argmax(-1)              # first True
    sel = ((torch.arange(K, device=free.device) == first_free[..., None])
           & (mask & free.any(-1))[..., None])                # [F, h, w, K]
    jet = jet_est.to(torch.int32).expand(mask.shape) \
        if isinstance(jet_est, torch.Tensor) \
        else torch.full(mask.shape, int(jet_est), dtype=torch.int32,
                        device=free.device)
    new = dict(
        flows=torch.where(sel[..., None, None], flows[:, :, :, None],
                          bank["flows"]),
        occl=torch.where(sel[..., None], occl[:, :, :, None], bank["occl"]),
        energy=torch.where(sel, energy[..., None], bank["energy"]),
        valid=bank["valid"] | sel,
        jet_est=torch.where(sel, jet[..., None], bank["jet_est"]),
    )
    return new, sel.any(-1)


def _bank_permute(bank, order):
    """Apply a per-pixel slot permutation (order [F, h, w, K])."""
    def take(a):
        idx = order.view(order.shape + (1,) * (a.dim() - order.dim()))
        return torch.take_along_dim(a, idx, 3)

    return {k: take(v) for k, v in bank.items()}


def _bank_sort(bank, keep_first=None):
    """Ascending-energy sort per pixel; `keep_first` ([F, h, w] slot
    indices) is pinned to position 0 first (dense_tracking.cpp:1384-1428)."""
    K = bank["energy"].shape[-1]
    e = torch.where(bank["valid"], bank["energy"], float("inf"))
    if keep_first is not None:
        sel = (torch.arange(K, device=e.device)
               == keep_first.long().clamp(0, K - 1)[..., None])
        e = torch.where(sel, float("-inf"), e)
    order = torch.sort(e, dim=-1, stable=True).indices
    return _bank_permute(bank, order)


def _bank_truncate(bank, n: int):
    K = bank["energy"].shape[-1]
    keep = torch.arange(K, device=bank["valid"].device) < n
    valid = bank["valid"] & keep
    return dict(bank, valid=valid,
                energy=torch.where(valid, bank["energy"], float("inf")))


def _bank_nms(bank, method: int, thres: float):
    """Greedy per-pixel non-maximum suppression by trajectory distance
    (dense_tracking.cpp:1585-1637). Assumes slots sorted by priority."""
    K = bank["energy"].shape[-1]
    d = trajectory_distance(bank["flows"][:, :, :, :, None],
                            bank["flows"][:, :, :, None], method)
    kept = bank["valid"][..., :1].clone()
    for k in range(1, K):
        close = ((d[..., k, :k] < thres) & kept).any(-1)
        kept = torch.cat([kept, (bank["valid"][..., k] & ~close)[..., None]],
                         -1)
    valid = bank["valid"] & kept
    return dict(bank, valid=valid,
                energy=torch.where(valid, bank["energy"], float("inf")))


def _evaluate_and_insert(bank, flows, mask, wj, rate, px, py, fields, cfg):
    """Occlusions and energy (+ the rate's weight wj) of one hypothesis per
    pixel, flows [F, h, w, J, 2], inserted where `mask`. The source rate
    index rides along so propagation re-applies weight_jet[jet_est]
    (dense_tracking.cpp:1244,1553)."""
    pen = make_penalty(cfg.penalty_fct_data, cfg.penalty_fct_data_eps)
    occl = set_occlusions(px, py, flows[:, :, :, None], fields["forward"],
                          fields["backward"], cfg.occlusion_threshold,
                          cfg.occlusion_fb_threshold)[:, :, :, 0]
    energy = hypothesis_energy(
        px, py, flows[:, :, :, None], occl[:, :, :, None], fields["forward"],
        fields["data"], fields["data_dx"], fields["data_dy"], pen,
        cfg.energy_params(), fields["occ_masks"])[:, :, :, 0] + wj
    return _bank_insert(bank, flows, occl, energy, rate, mask)[0]


# --------------------------------------------------------------------------
# initial hypotheses
# --------------------------------------------------------------------------
def build_initial_hypotheses(bank, cfg: TrackingConfig, rate_flows, fields,
                             weight_jet, epic_ctx, timing=None):
    """Hypothesis generation from each jet estimation
    (dense_tracking.cpp:1098-1360) for one final pair: bank with F = 1,
    `fields` its device tensors (`_device_fields`). Returns (bank,
    consistent [h, w] np.bool_). `timing` accumulates "warp" (accumulation)
    and "data" (energy evaluation) seconds, mirroring dt_warp_time /
    dt_sum_time (dense_tracking.cpp:305,336)."""
    from ..utils.segments import remove_small_segments

    device = bank["energy"].device
    timing = timing if timing is not None else {}
    timing.setdefault("warp", 0.0)
    timing.setdefault("data", 0.0)
    xy_incr = cfg.skip_pixel + 1
    h, w = bank["energy"].shape[1:3]
    px, py = _grid_positions(h, w, xy_incr, int(0.5 * cfg.skip_pixel),
                             device)

    consistent = np.zeros((h, w), bool)
    for r, (r_fwd, r_bwd, r_occ) in enumerate(rate_flows):
        r_jets = r_fwd.shape[0]
        t0 = time.time()
        with span("dt.accumulate"):
            acc, tracked = accumulate_consistent_batches(
                r_fwd, r_bwd, r_occ, cfg.consistency_threshold,
                cfg.skip_pixel, cfg.discard_inconsistent, device=device)
            fully_t = tracked == r_jets
            fully = fully_t.cpu().numpy()             # [h, w] bool, tiny
        timing["warp"] += time.time() - t0
        consistent |= fully

        t0 = time.time()
        with span("dt.evaluate"):
            flows = adapt_fps(acc.permute(1, 2, 0, 3), cfg.jets)[None]
            bank = _evaluate_and_insert(bank, flows, fully_t[None],
                                        float(weight_jet[r]), r, px, py,
                                        fields, cfg)
            _sync(device)
        timing["data"] += time.time() - t0

        # EPIC-interpolated hypotheses from the consistent matches; isolated
        # consistent speckles are removed first (dense_tracking.cpp:1265)
        if cfg.epic_interpolation and epic_ctx is not None:
            r_cons = fully.astype(np.int32)
            with span("dt.remove_segments"):
                remove_small_segments(r_cons, 0.1, 100)
            with phase("dt.epic_hypotheses"):
                epic_flows = _epic_hypotheses(acc.cpu().numpy(), r_cons > 0,
                                              cfg, epic_ctx, device)
            if epic_flows is not None:
                t0 = time.time()
                with span("dt.evaluate"):
                    eflows = adapt_fps(
                        torch.as_tensor(epic_flows, device=device),
                        cfg.jets)[None]
                    bank = _evaluate_and_insert(
                        bank, eflows,
                        torch.ones((1, h, w), dtype=torch.bool,
                                   device=device),
                        float(weight_jet[r]), r, px, py, fields, cfg)
                    _sync(device)
                timing["data"] += time.time() - t0
    return bank, consistent


def _epic_hypotheses(acc, consistent, cfg: TrackingConfig, epic_ctx, device):
    """EPIC interpolation of each jet's consistent accumulated flow
    (dense_tracking.cpp:1268-1350): the per-jet interpolations are one
    `epic_batched` call. acc [r_jets, h, w, 2] host array. Returns
    [h, w, r_jets, 2] or None."""
    from ..core.image import saliency as saliency_fn
    from ..epic import epic_batched

    imlab, edges, epic_params = epic_ctx
    r_jets, h, w = acc.shape[:3]
    xy_incr = cfg.skip_pixel + 1
    skip = cfg.epic_skip
    ys, xs = np.mgrid[int(0.5 * skip):h:skip, int(0.5 * skip):w:skip]
    sel = consistent[ys, xs]
    if sel.sum() < 8:
        return None
    sx = xs[sel]
    sy = ys[sel]

    sal = None
    if epic_params.saliency_th:
        sal = saliency_fn(torch.as_tensor(np.asarray(imlab, np.float32),
                                          device=device), 0.8, 1.0)
        sal = sal.cpu().numpy()
    jobs = []
    for j in range(r_jets):
        m = np.stack([
            sx, sy,
            sx + acc[j][sy, sx, 0] / xy_incr,
            sy + acc[j][sy, sx, 1] / xy_incr,
        ], 1).astype(np.float32)
        jobs.append((imlab, m, edges, sal))
    flows = epic_batched(jobs, epic_params, device=device)

    out = np.zeros((h, w, r_jets, 2), np.float32)
    for j, flow in enumerate(flows):
        out[:, :, j, 0] = flow[:h, :w, 0] * xy_incr
        out[:, :, j, 1] = flow[:h, :w, 1] * xy_incr
    return out


# --------------------------------------------------------------------------
# the alternation, in segments
# --------------------------------------------------------------------------
# TrackingConfig fields that become constants of the alternation's segments
# (with the device, F, h, w, K = capacity, J = jets, jet-occlusion
# availability and the number of rates: `stage3_key`); the solve's own
# (approach, trws_eps, trws_max_iter) key its graphs (`mrf.solve_key`), and
# the rest only steer the host (the initial bank, the number of
# alternations, the draws' seed).
GRAPH_FIELDS = ("skip_pixel", "acc_jc", "acc_bc", "acc_gc", "acc_occ",
                "acc_beta", "acc_spatial_occ", "acc_cv", "acc_temporal_occ",
                "occlusion_threshold", "occlusion_fb_threshold", "neigh_hyp",
                "neigh_hyp_radius", "hyp_neigh_tryouts", "nn_skip1",
                "nn_skip2", "perturb_keep", "traj_sim_method",
                "traj_sim_thres", "penalty_fct_data", "penalty_fct_data_eps")
SOLVE_FIELDS = ("approach", "trws_eps", "trws_max_iter")


def stage3_key(cfg: TrackingConfig, device, nf: int, h: int, w: int,
               has_occ: bool, n_rates: int):
    """The cache key of one alternation shape's graphs."""
    return ("stage3", torch.device(device), nf, h, w, cfg.capacity, cfg.jets,
            bool(has_occ), int(n_rates)) + tuple(
                getattr(cfg, f) for f in GRAPH_FIELDS)


class _Alternation(graphs.Segments):
    """The alternation of `track_final_pairs_batched` over inputs `ins`
    (the energy fields, `consistent`, `weight_jet`) and a state namespace
    `st` (the bank, the selection, a pass's draws, lattice sources and
    insertion counts), cut into segments that read nothing on the host,
    aligned with the JAX package's jitted programs: `sort` (sort_first /
    sort_keep), the propagation pass (`_propagation_kernel`: per stride its
    `sources`, per tryout group its insertions, then the `energies` of
    what the pass inserted), `nms`, `unary` (unary_of), `pairwise`
    (pairwise_of); `select` runs solve_multilabel (its own segments).

    Propagation follows the reference's sequential insertion semantics
    (dense_tracking.cpp:1434-1583). Insertion decisions depend only on
    source validity, the `want` budget and trajectory-similarity
    rejection, never on the candidate's energy (the reference computes the
    energy merely to store it, dense_tracking.cpp:1544-1575); candidates
    come from slot 0, which insertions never modify. So the insertion loop
    runs first with placeholder energies, and one evaluation then fills the
    energy and occlusions of every slot inserted in the pass. A final pair
    whose pixels all adopted `want` proposals stops inserting (the
    reference's tryout break, :1580-1582); the others go on: that
    per-final test is read between tryout groups. In a graph program
    (`graphed`) `ins` and `st` are its Slots."""

    def __init__(self, cfg: TrackingConfig, ins, st, graphed=False):
        super().__init__(st, graphed)
        self.cfg, self.ins = cfg, ins
        self.xy_incr = cfg.skip_pixel + 1
        self.xy_start = int(0.5 * cfg.skip_pixel)
        self.ntry = cfg.hyp_neigh_tryouts
        self.group = max(1, min(4, self.ntry))

    # ------------------------------------------------------------ the bank
    def sort(self, first: bool):
        """Ascending energies; after the first alternation the selected
        slot first and the bank cut to 1 + perturb_keep slots."""
        st = self.st
        st.bank = _bank_sort(st.bank) if first else _bank_truncate(
            _bank_sort(st.bank, keep_first=st.selected),
            1 + self.cfg.perturb_keep)

    def nms(self):
        st = self.st
        st.bank = _bank_nms(st.bank, self.cfg.traj_sim_method,
                            self.cfg.traj_sim_thres)

    def unary(self):
        st = self.st
        st.unary = torch.where(st.bank["valid"], st.bank["energy"], BIG)

    def pairwise(self):
        st, cfg = self.st, self.cfg
        bank = st.bank
        safe = torch.where(bank["valid"][..., None, None], bank["flows"], 0.0)
        st.cost_r, st.cost_d = pairwise_costs(
            safe, bank["occl"], self.ins.fields["smooth_weight"],
            cfg.acc_beta, cfg.acc_spatial_occ, cfg.traj_sim_method,
            self.xy_incr, self.xy_start)

    def select(self):
        """The TRW / BP solve; returns (energy, lower bound) [F]."""
        st, cfg = self.st, self.cfg
        selected, energy, lb = solve_multilabel(
            st.unary, st.cost_r, st.cost_d, iters=cfg.trws_max_iter,
            approach=cfg.approach, eps=cfg.trws_eps, _eager=not self.graphed)
        st.selected = selected
        return energy, lb

    # -------------------------------------------------------- propagation
    def _live(self, t: int):
        """Per final pair: not every pixel has adopted `want` proposals."""
        want = (t + 1) * self.cfg.neigh_hyp
        return ~(self.st.added >= want).flatten(1).all(-1)

    def sources(self, t: int, stride: int):
        """Stride t's proposal sources from the draws st.ang / st.u: a
        stratified offset, truncated toward zero, then floor-divided onto
        the consistent-pixel lattice."""
        st, cfg = self.st, self.cfg
        nf, h, w = st.bank["energy"].shape[:3]
        device = st.ang.device
        if t == 0:
            st.valid0 = st.bank["valid"]           # pass-start snapshot
        radius = (t + 1) * cfg.neigh_hyp_radius / self.xy_incr
        yy, xx = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        rad = torch.sqrt(st.u) * radius
        sx_all = (xx + rad * torch.cos(st.ang)).to(torch.int64).clamp(0, w - 1)
        sy_all = (yy + rad * torch.sin(st.ang)).to(torch.int64).clamp(0, h - 1)
        st.sx = (torch.div(sx_all - 1, stride, rounding_mode="floor")
                 * stride + 1).clamp(0, w - 1)
        st.sy = (torch.div(sy_all - 1, stride, rounding_mode="floor")
                 * stride + 1).clamp(0, h - 1)
        st.added = torch.zeros((nf, h, w), dtype=torch.int32, device=device)
        self.mark(self._live(t))

    def tryouts(self, t: int, g0: int, use_consistent: bool):
        """One tryout group of stride t: sequential insertion with
        similarity rejection; d_bank rows are refreshed per group while
        in-group candidates check each other through d_cand."""
        st, cfg, ins = self.st, self.cfg, self.ins
        bank, added = st.bank, st.added
        nf, h, w, K, J = bank["flows"].shape[:5]
        device = added.device
        want = (t + 1) * cfg.neigh_hyp
        thres = cfg.traj_sim_thres
        live = self._live(t)
        yy, xx = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        fi = torch.arange(nf, device=device).view(nf, 1, 1, 1)
        zero_occl = torch.zeros((nf, h, w, J + 1), dtype=torch.int32,
                                device=device)
        zero_energy = torch.zeros((nf, h, w), device=device)

        sxg = st.sx[g0:g0 + self.group]
        syg = st.sy[g0:g0 + self.group]
        n = sxg.shape[0]
        cand_flows = bank["flows"][fi, syg[None], sxg[None], 0]
        cand_flows = cand_flows.permute(0, 2, 3, 1, 4, 5)  # [F,h,w,n,J,2]
        cand_jet = bank["jet_est"][fi, syg[None], sxg[None], 0] \
            .permute(0, 2, 3, 1)
        src_valid = bank["valid"][fi, syg[None], sxg[None], 0]
        if use_consistent:
            src_valid = src_valid & ins.consistent[fi, syg[None], sxg[None]]
        src_valid = src_valid.permute(0, 2, 3, 1)

        d_bank = trajectory_distance(cand_flows[:, :, :, :, None],
                                     bank["flows"][:, :, :, None],
                                     cfg.traj_sim_method)  # [F,h,w,n,K]
        d_cand = trajectory_distance(cand_flows[:, :, :, :, None],
                                     cand_flows[:, :, :, None],
                                     cfg.traj_sim_method)  # [F,h,w,n,n]
        inserted_prev = []
        for i in range(n):
            src_ok = (src_valid[..., i]
                      & ((sxg[i] != xx) | (syg[i] != yy))
                      & (added < want) & live.view(nf, 1, 1))
            similar = ((d_bank[..., i, :] < thres) & bank["valid"]).any(-1)
            for j in range(i):
                similar = similar | (inserted_prev[j]
                                     & (d_cand[..., i, j] < thres))
            ins_i = src_ok & ~similar
            bank, _ = _bank_insert(bank, cand_flows[..., i, :, :], zero_occl,
                                   zero_energy, cand_jet[..., i], ins_i)
            inserted_prev.append(ins_i)
            added = added + ins_i.to(torch.int32)
        st.bank, st.added = bank, added
        self.mark(self._live(t))

    def energies(self):
        """One energy / occlusion evaluation over every slot inserted this
        pass (flows were recorded above; energies are pure functions of
        them), plus each slot's rate weight."""
        st, cfg, fields = self.st, self.cfg, self.ins.fields
        bank = st.bank
        h, w = bank["energy"].shape[1:3]
        device = bank["energy"].device
        inserted = bank["valid"] & ~st.valid0                 # [F, h, w, K]
        px, py = _grid_positions(h, w, self.xy_incr, self.xy_start, device)
        pen = make_penalty(cfg.penalty_fct_data, cfg.penalty_fct_data_eps)
        occl_all = set_occlusions(px, py, bank["flows"], fields["forward"],
                                  fields["backward"], cfg.occlusion_threshold,
                                  cfg.occlusion_fb_threshold)
        energy_all = hypothesis_energy(
            px, py, bank["flows"], occl_all, fields["forward"],
            fields["data"], fields["data_dx"], fields["data_dy"], pen,
            cfg.energy_params(), fields.get("occ_masks"))
        weight_jet = self.ins.weight_jet
        rates = torch.arange(weight_jet.shape[0], device=device)
        wj = (weight_jet * (bank["jet_est"][..., None] == rates)).sum(-1)
        st.bank = dict(
            bank, occl=torch.where(inserted[..., None], occl_all, bank["occl"]),
            energy=torch.where(inserted, energy_all + wj, bank["energy"]))

    def propagate(self, run, draws, p_it: int):
        """One propagation pass over both lattice strides and all tryout
        groups (the JAX package's `_propagation_kernel`), each segment
        through run(segment, fn); the draws are made on the host and copied
        into st.ang / st.u before their stride's segments."""
        st, cfg = self.st, self.cfg
        h, w = st.bank["energy"].shape[1:3]
        device = st.bank["energy"].device
        use_consistent = p_it == 0
        for t, stride in enumerate((cfg.nn_skip1, cfg.nn_skip2)):
            ang, u = draws(p_it, t, self.ntry, h, w)
            st.ang = torch.as_tensor(ang, dtype=torch.float32, device=device)
            st.u = torch.as_tensor(u, dtype=torch.float32, device=device)
            run(("sources", t, stride), lambda: self.sources(t, stride))
            for g0 in range(0, self.ntry, self.group):
                # the reference's tryout-loop break, per final pair
                if not self.read():
                    break
                run(("tryouts", t, g0, use_consistent),
                    lambda: self.tryouts(t, g0, use_consistent))
        run(("energies",), self.energies)


# --------------------------------------------------------------------------
# per final pair
# --------------------------------------------------------------------------
def _device_fields(job, device):
    """The per-final inputs the energies read, as device tensors."""
    return dict(forward=as_f32(job["forward"], device),
                backward=as_f32(job["backward"], device),
                data=as_f32(job["data"], device),
                data_dx=as_f32(job["data_dx"], device),
                data_dy=as_f32(job["data_dy"], device),
                occ_masks=_occ_tensor(job["occlusions"], device),
                smooth_weight=as_f32(job["smooth_weight"], device))


def _init_final_state(cfg: TrackingConfig, job, weight_jet, device, timing):
    """Initial hypothesis bank of one final pair (F = 1): per-rate
    accumulation, EPIC interpolation, energies, plus the guaranteed
    zero-flow outlier. Returns a dict of [1, ...] device tensors: the bank,
    `consistent` [1, h, w] and the energy fields."""
    J = cfg.jets
    xy_incr = cfg.skip_pixel + 1
    oh, ow = np.shape(job["data"])[1:3]
    h = int(np.floor(oh / xy_incr))
    w = int(np.floor(ow / xy_incr))
    fields = _device_fields(job, device)
    one = {k: None if v is None else v[None] for k, v in fields.items()}

    bank = _new_bank(1, h, w, cfg.capacity, J, device)
    rate_flows = [(as_f32(f, device), as_f32(b, device),
                   _occ_tensor(o, device)) for f, b, o in job["rate_flows"]]
    bank, consistent = build_initial_hypotheses(
        bank, cfg, rate_flows, one, weight_jet, job.get("epic_ctx"), timing)

    # guarantee at least one hypothesis everywhere: zero-flow outlier
    zero_flow = torch.zeros((1, h, w, J, 2), device=device)
    occl0 = torch.ones((1, h, w, J + 1), dtype=torch.int32, device=device)
    occl0[..., 0] = 0
    energy0 = torch.full((1, h, w), 1e6, device=device)
    bank, _ = _bank_insert(bank, zero_flow, occl0, energy0, 0,
                           ~bank["valid"].any(-1))
    return dict(bank,
                consistent=torch.as_tensor(consistent, device=device)[None],
                **{k: v for k, v in one.items() if v is not None})


def _readback(flows, occl, selected, J, xy_incr):
    """Final flow [F, h, w, 2] and occlusion flags [F, h, w] of the selected
    slot per pixel."""
    sel = selected.long()[..., None]
    final_flow = torch.take_along_dim(flows[..., J - 1, :], sel[..., None],
                                      3)[..., 0, :] / xy_incr
    occ_any = torch.take_along_dim(occl.amax(-1), sel, 3)[..., 0] > 0
    return final_flow, occ_any


@contextlib.contextmanager
def _own_stream(device):
    """Device work of a helper thread on a CUDA stream of its own, finished
    before the block is left."""
    if device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        yield
    stream.synchronize()


def track_final_pair(cfg: TrackingConfig, rate_flows, forward, backward,
                     occlusions, data, data_dx, data_dy, smooth_weight,
                     weight_jet=None, epic_ctx=None, verbose=False,
                     device=None, draws=None):
    """Full alternating optimization for one final frame pair.

    rate_flows: list of (forward [Jr, H, W, 2], backward, occl-or-None) per
    frame rate (index 0 = the reference/min-fps rate).
    forward/backward: the min-fps jet flows [J, H, W, 2].
    data*: [J+1, H, W, 3] normalized images and derivatives.
    smooth_weight: [H, W].
    device: None = CUDA (raises without a GPU). draws: the propagation's
    source of draws (default `default_draws(cfg.seed, device)`).
    Returns (flow [h, w, 2], occlusion_map [h, w] uint8, info dict).
    """
    job = dict(rate_flows=rate_flows, forward=forward, backward=backward,
               occlusions=occlusions, data=data, data_dx=data_dx,
               data_dy=data_dy, smooth_weight=smooth_weight,
               epic_ctx=epic_ctx)
    flows, occs, info = track_final_pairs_batched(
        cfg, [job], weight_jet, verbose=verbose, device=device, draws=draws)
    return flows[0], occs[0], info


def track_final_pairs_batched(cfg: TrackingConfig, jobs, weight_jet=None,
                              verbose=False, init_workers=0, device=None,
                              draws=None, *, _eager=False):
    """Alternating optimization for F final frame pairs side by side.

    The reference parallelizes stage 3 by OpenMP-ing whole final pairs
    across CPU cores (dense_tracking.cpp:726-727); here the per-final
    tensors share shapes, so the bank gains a leading F axis and every
    alternation step runs once for all F.

    jobs: list of dicts with keys rate_flows, forward, backward,
    occlusions, data, data_dx, data_dy, smooth_weight, epic_ctx — the
    same per-final inputs as `track_final_pair`. All jobs must share
    shapes and occlusion availability. The per-final bank initialization
    (host-heavy: accumulation + EPIC interpolation) optionally overlaps on
    `init_workers` threads, each with its own CUDA stream.

    On CUDA the alternation replays this thread's cached CUDA graphs of its
    segments (`_Alternation`, variational/graphs.py; the TRW / BP solve its
    own), the JAX package's jitted propagation and selection programs,
    bitwise the eager alternation; the CPU runs it eagerly, and so does
    `_eager` (tests and chip_smoke.py only). The initialization stays eager
    (its distance transforms replay their own graphs).

    Returns (flows list of [h, w, 2], occ_maps list of uint8 [h, w], info).
    """
    with span("dt.call"):
        return _track_final_pairs(cfg, jobs, weight_jet, verbose,
                                  init_workers, device, draws, _eager)


def _track_final_pairs(cfg, jobs, weight_jet, verbose, init_workers, device,
                       draws, _eager):
    device = resolve_device(device)
    if weight_jet is None:
        weight_jet = np.arange(cfg.rates, dtype=np.float32)
    if draws is None:
        draws = default_draws(cfg.seed, device)
    F = len(jobs)
    timing = {"warp": 0.0, "median": 0.0, "data": 0.0,
              "unary": 0.0, "pairwise": 0.0, "optimization": 0.0}
    has_occ = jobs[0]["occlusions"] is not None
    if any((j["occlusions"] is not None) != has_occ for j in jobs):
        raise ValueError("all batched finals must agree on jet-occlusion "
                         "availability")
    J = cfg.jets
    xy_incr = cfg.skip_pixel + 1

    def init_one(job, threaded):
        t = {}
        with phase("dt.init_final"), \
                _own_stream(device) if threaded else contextlib.nullcontext():
            state = _init_final_state(cfg, job, weight_jet, device, t)
        return state, t

    if init_workers and init_workers > 1 and F > 1:
        with ThreadPoolExecutor(min(init_workers, F)) as ex:
            inits = list(ex.map(lambda j: init_one(j, True), jobs))
        if device.type == "cuda":
            # made on the helpers' streams, read and freed on this one
            for state, _ in inits:
                for v in state.values():
                    v.record_stream(torch.cuda.current_stream(device))
    else:
        inits = [init_one(j, False) for j in jobs]
    for _, t in inits:
        for k, v in t.items():
            timing[k] = timing.get(k, 0.0) + v

    # stack the banks and per-final inputs along the leading F axis
    state = {k: torch.cat([s[k] for s, _ in inits]) for k in inits[0][0]}
    del inits
    bank = {k: state.pop(k) for k in ("flows", "occl", "energy", "valid",
                                      "jet_est")}
    consistent = state.pop("consistent")
    weight_jet_t = torch.as_tensor(np.asarray(weight_jet, np.float32),
                                   device=device)

    h, w = bank["energy"].shape[1:3]
    info = {"variables": [], "factors": [], "timing": timing}
    graphed = not _eager and device.type == "cuda"
    key = stage3_key(cfg, device, F, h, w, has_occ, weight_jet_t.shape[0])
    with graphs.running(key, device, graphed) as prog:
        ins, st = prog.inputs, prog.state
        ins.fields, ins.consistent, ins.weight_jet = \
            state, consistent, weight_jet_t
        st.bank = bank
        del state, bank
        if prog.level is None:
            prog.level = _Alternation(cfg, ins, st, prog.graphed)
        alt, run = prog.level, prog.run
        for p_it in range(cfg.alternate):
            with span("dt.alternate"):
                if p_it == 0:
                    run(("sort_first",), lambda: alt.sort(True))
                else:
                    run(("sort_keep",), lambda: alt.sort(False))

                t0 = time.time()
                with span("dt.propagate"):
                    alt.propagate(run, draws, p_it)
                run(("nms",), alt.nms)
                _sync(device)
                # candidate-energy evaluation = the reference's dt_sum_time
                # row (dense_tracking.cpp:336,1571)
                timing["data"] += time.time() - t0

                t0 = time.time()
                run(("unary",), alt.unary)
                _sync(device)
                timing["unary"] += time.time() - t0

                t0 = time.time()
                run(("pairwise",), alt.pairwise)
                _sync(device)
                timing["pairwise"] += time.time() - t0

                t0 = time.time()
                with span("dt.select"):
                    energy, lb = alt.select()
                _sync(device)
                timing["optimization"] += time.time() - t0
            info["variables"].append(h * w)
            info["factors"].append(int(2 * h * w - h - w + h * w))
            if verbose:
                print(f"  alternate {p_it}"
                      + (f" (batch {F})" if F > 1 else "")
                      + f": energy={float(energy.sum()):.1f} "
                      f"lower_bound={float(lb.sum()):.1f} "
                      f"hyps={int(st.bank['valid'].sum())}")

        with span("dt.readback"):
            final_flow, occ_any = _readback(st.bank["flows"],
                                            st.bank["occl"], st.selected, J,
                                            xy_incr)
            flows_np = final_flow.cpu().numpy().astype(np.float32)
            occs_np = occ_any.cpu().numpy()
    return ([flows_np[i] for i in range(F)],
            [occs_np[i].astype(np.uint8) * 255 for i in range(F)],
            info)
