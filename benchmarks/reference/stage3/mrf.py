"""Multi-label grid MRF for trajectory selection, TRW / BP message passing
(frozen copy of the port's `tracking.mrf`).

The reference hands a grid MRF (per-pixel label = hypothesis index, unary =
trajectory energy, pairwise = smoothness-weighted trajectory distance plus
occlusion disagreement) to the sequential TRW-S v1.3 library with a BP
alternative (dense_tracking.cpp:1654-1872). Here min-sum message passing is
*synchronous* over the 4-connected grid:

  - `approach=0` (TRW): tree-reweighted updates with uniform edge appearance
    probabilities rho = 0.5 (each edge is in half of the row / column
    chains), stopped on the chain-decomposition bound and the message
    residual;
  - `approach=1` (BP): plain damped loopy min-sum for `iters` iterations.

Messages are [F, H, W, K] tensors (F final pairs solved side by side; an
unbatched problem is F = 1); one iteration is a handful of broadcast
min-reductions over [F, H, W, K, K]. Here the solve runs eagerly (the port
replays the same operations as CUDA graphs).
"""
from __future__ import annotations

import torch

from .support import Segments, row_blocks

BIG = 1e9


def _shift(x, dy, dx, fill=0.0):
    """out[:, y, x] = x[:, y + dy, x + dx] over dims 1, 2 of an F-leading
    tensor; `fill` where that lies outside."""
    h, w = x.shape[1:3]
    out = torch.full_like(x, fill)
    out[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        x[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


class _Solve(Segments):
    """solve_multilabel over a state namespace `st` (inputs unary, cost_r,
    cost_d [F, ...]; the messages, the running bound `best`, `progress`),
    cut into segments that read nothing on the host: the start, one TRW
    iteration, the BP branch's fixed iterations, the labelling and its
    energy. The TRW stop test is read between iterations (the JAX
    package's `lax.while_loop`)."""

    def __init__(self, st, iters: int, approach: int, damping: float,
                 eps: float):
        super().__init__(st)
        self.iters, self.approach = iters, approach
        self.damping, self.eps = damping, eps
        self.rho = 0.5 if approach == 0 else 1.0

    # ---------------------------------------------------------- the steps
    def beliefs(self, msgs):
        m_from_l, m_from_r, m_from_u, m_from_d = msgs
        return self.st.unary + self.rho * (m_from_l + m_from_r + m_from_u
                                           + m_from_d)

    @staticmethod
    def send(b_minus, cost):
        # min over sender labels k1 of (b_minus[k1] + cost[k1, k2])
        m = (b_minus[..., :, None] + cost).amin(-2)
        return m - m.amin(-1, keepdim=True)

    def iteration(self, msgs):
        st, rho, damping = self.st, self.rho, self.damping
        m_from_l, m_from_r, m_from_u, m_from_d = msgs
        b = self.beliefs(msgs)
        # message p -> right neighbour: exclude what q sent us
        new_to_r = self.send(b - rho * m_from_r, st.cost_r)
        new_to_l = self.send(b - rho * m_from_l, st.cost_l)
        new_to_d = self.send(b - rho * m_from_d, st.cost_d)
        new_to_u = self.send(b - rho * m_from_u, st.cost_u)

        def mix(old, new):
            return damping * old + (1 - damping) * new

        return (mix(m_from_l, _shift(new_to_r, 0, -1)),
                mix(m_from_r, _shift(new_to_l, 0, 1)),
                mix(m_from_u, _shift(new_to_d, -1, 0)),
                mix(m_from_d, _shift(new_to_u, 1, 0)))

    def bound(self, msgs):
        """Chain-decomposition dual (the monotone TRW-S bound contract,
        dense_tracking.cpp:1816-1831 / Kolmogorov PAMI 2006 eq. 13): every
        node term split equally between its row chain and its column chain,
        each chain solved exactly by min-sum DP (a sequential loop over the
        columns, then over the rows), the minima summed. Returns [F]."""
        st, rho = self.st, self.rho
        h, w = st.unary.shape[1:3]
        m_l, m_r, m_u, m_d = msgs
        th = 0.5 * (st.unary + rho * (m_l + m_r + m_u + m_d))
        e_r = (st.cost_r[:, :, :-1]
               - rho * (m_l[:, :, 1:, None, :] + m_r[:, :, :-1, :, None]))
        e_d = (st.cost_d[:, :-1]
               - rho * (m_u[:, 1:, :, None, :] + m_d[:, :-1, :, :, None]))
        acc_r = th[:, :, 0]
        for x in range(w - 1):
            acc_r = (acc_r[..., :, None] + e_r[:, :, x]).amin(-2) \
                + th[:, :, x + 1]
        acc_d = th[:, 0]
        for y in range(h - 1):
            acc_d = (acc_d[..., :, None] + e_d[:, y]).amin(-2) + th[:, y + 1]
        return acc_r.amin(-1).sum(-1) + acc_d.amin(-1).sum(-1)

    # ----------------------------------------------------------- segments
    def start(self):
        """The left / up costs, zero messages and (TRW) the first bound."""
        st = self.st
        st.cost_l = _shift(st.cost_r, 0, -1).transpose(-1, -2)
        st.cost_u = _shift(st.cost_d, -1, 0).transpose(-1, -2)
        zero = torch.zeros_like(st.unary)
        st.msgs = (zero, zero, zero, zero)
        if self.approach == 0:
            st.best = self.bound(st.msgs)
            st.progress = torch.full((st.unary.shape[0],), float("inf"),
                                     device=st.unary.device)
            self.mark(st.progress >= self.eps)

    def trw(self):
        """One TRW iteration of the problems still live; a problem that
        has stopped keeps its state."""
        st = self.st
        nf = st.unary.shape[0]
        live = st.progress >= self.eps
        new = self.iteration(st.msgs)
        lb = self.bound(new)
        res = torch.stack([(n - o).abs().amax((1, 2, 3))
                           for n, o in zip(new, st.msgs)]).amax(0)
        keep = live.view(nf, 1, 1, 1)
        st.msgs = tuple(torch.where(keep, n, o) for n, o in zip(new, st.msgs))
        st.progress = torch.where(live, torch.maximum(lb - st.best, res),
                                  st.progress)
        st.best = torch.where(live, torch.maximum(st.best, lb), st.best)
        self.mark(st.progress >= self.eps)

    def bp(self):
        """The reference's Minimize_BP runs to m_iterMax regardless of
        eps."""
        st = self.st
        msgs = st.msgs
        for _ in range(self.iters):
            msgs = self.iteration(msgs)
        st.msgs = msgs
        st.best = self.bound(msgs)

    def tail(self):
        """The labelling and its energy."""
        st = self.st
        labels = self.beliefs(st.msgs).argmin(-1).to(torch.int32)
        lab = labels.long()[..., None]
        e_unary = torch.take_along_dim(st.unary, lab, -1)[..., 0].sum((1, 2))
        lab_r = _shift(lab, 0, 1)
        lab_d = _shift(lab, 1, 0)
        e_r = torch.take_along_dim(
            torch.take_along_dim(st.cost_r, lab[..., None], -2)[..., 0, :],
            lab_r, -1)[..., 0]
        e_d = torch.take_along_dim(
            torch.take_along_dim(st.cost_d, lab[..., None], -2)[..., 0, :],
            lab_d, -1)[..., 0]
        st.labels = labels
        st.energy = (e_unary + e_r[:, :, :-1].sum((1, 2))
                     + e_d[:, :-1].sum((1, 2)))

    def drive(self, run):
        """The solve's host loop: each segment through run(segment, fn),
        the stop test read between TRW iterations."""
        run(("start",), self.start)
        if self.approach == 0:
            # TRW-S stopping semantics (dense_tracking.cpp:660-661 feeding
            # MRFEnergy options): iterate until the lower-bound improvement
            # per iteration falls below acc_trws_eps, capped at
            # acc_trws_max_iter; gated on the larger of the bound
            # improvement and the message residual, since the synchronous
            # dual can plateau an iteration or two before the damped
            # messages stop moving. The reported bound is the running max
            # of the dual. One host read of the stop test per iteration.
            for _ in range(self.iters):
                if not self.read():
                    break
                run(("trw",), self.trw)
        else:
            run(("bp",), self.bp)
        run(("tail",), self.tail)


def solve_multilabel(unary, cost_r, cost_d, iters: int = 10,
                     approach: int = 0, damping: float = 0.5,
                     eps: float = 1e-5):
    """Minimize sum_p unary[p, l_p] + sum_{pq} C_pq[l_p, l_q].

    unary:  [H, W, K] (+BIG for invalid labels)
    cost_r: [H, W, K, K] pairwise to the right neighbour (K_p x K_q)
    cost_d: [H, W, K, K] pairwise to the down neighbour
    (each with a leading final-pair axis F for F problems at once; each
    stops on its own test, as if solved alone).
    Returns (labels [H, W] int32, energy, lower_bound), energy and bound
    0-dim tensors (or [F]).

    On CUDA the solve replays this thread's cached CUDA graphs of its
    segments (`_Solve`, variational/graphs.py), bitwise the eager solve;
    the CPU runs it eagerly, and so does `_eager` (tests and
    chip_smoke.py only)."""
    batched = unary.dim() == 4
    if not batched:
        unary, cost_r, cost_d = unary[None], cost_r[None], cost_d[None]
    from types import SimpleNamespace

    st = SimpleNamespace(unary=unary, cost_r=cost_r, cost_d=cost_d)
    solve = _Solve(st, iters, approach, damping, eps)
    solve.drive(solve.run)
    out = (st.labels, st.energy, st.best)
    if not batched:
        return tuple(x[0] for x in out)
    return out                            # chain-decomposition dual


def pairwise_costs(flows, occl, smooth_weight, beta, spatial_occ, method,
                   xy_incr=1, xy_start=0):
    """Edge cost tensors for solve_multilabel.

    flows [H, W, K, J, 2], occl [H, W, K, J+1], smooth_weight [Ho, Wo] at the
    *original* resolution (sampled at the subsampled grid positions,
    dense_tracking.cpp:1722-1766); each with a leading final-pair axis F for
    F problems. Returns (cost_r, cost_d) each [H, W, K, K] (or [F, ...]).
    """
    from .hypothesis import trajectory_distance

    batched = flows.dim() == 6
    if not batched:
        flows, occl = flows[None], occl[None]
        smooth_weight = smooth_weight[None]
    h, w = flows.shape[1:3]
    dev = flows.device
    ys = torch.arange(h, device=dev) * xy_incr + xy_start
    xs = torch.arange(w, device=dev) * xy_incr + xy_start
    sw = smooth_weight[:, ys[:, None], xs[None, :]]

    K, J = flows.shape[3:5]

    def edge_cost(dy, dx):
        fb = _shift(flows, dy, dx)
        ob = _shift(occl, dy, dx)
        sw_pair = sw + _shift(sw, dy, dx)
        out = []
        for rows in row_blocks(h, w * K * K * J * 2):
            d = trajectory_distance(flows[:, rows, :, :, None],
                                    fb[:, rows, :, None], method)
            occ_dis = (occl[:, rows, :, :, None]
                       != ob[:, rows, :, None]).sum(-1)
            out.append(sw_pair[:, rows, :, None, None]
                       * (beta * d + spatial_occ * occ_dis))
        return torch.cat(out, 1)

    cost_r, cost_d = edge_cost(0, 1), edge_cost(1, 0)
    if not batched:
        return cost_r[0], cost_d[0]
    return cost_r, cost_d
