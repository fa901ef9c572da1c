"""Multi-label grid MRF for trajectory selection, TRW / BP message passing
(torch port of `slowflow_tpu.tracking.mrf`).

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
min-reductions over [F, H, W, K, K].
"""
from __future__ import annotations

import torch

BIG = 1e9


def _shift(x, dy, dx, fill=0.0):
    """out[:, y, x] = x[:, y + dy, x + dx] over dims 1, 2 of an F-leading
    tensor; `fill` where that lies outside."""
    h, w = x.shape[1:3]
    out = torch.full_like(x, fill)
    out[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        x[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


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
    """
    batched = unary.dim() == 4
    if not batched:
        unary, cost_r, cost_d = unary[None], cost_r[None], cost_d[None]
    nf, h, w, K = unary.shape
    rho = 0.5 if approach == 0 else 1.0

    cost_l = _shift(cost_r, 0, -1).transpose(-1, -2)
    cost_u = _shift(cost_d, -1, 0).transpose(-1, -2)

    def beliefs(msgs):
        m_from_l, m_from_r, m_from_u, m_from_d = msgs
        return unary + rho * (m_from_l + m_from_r + m_from_u + m_from_d)

    def send(b_minus, cost):
        # min over sender labels k1 of (b_minus[k1] + cost[k1, k2])
        m = (b_minus[..., :, None] + cost).amin(-2)
        return m - m.amin(-1, keepdim=True)

    def iteration(msgs):
        m_from_l, m_from_r, m_from_u, m_from_d = msgs
        b = beliefs(msgs)
        # message p -> right neighbour: exclude what q sent us
        new_to_r = send(b - rho * m_from_r, cost_r)
        new_to_l = send(b - rho * m_from_l, cost_l)
        new_to_d = send(b - rho * m_from_d, cost_d)
        new_to_u = send(b - rho * m_from_u, cost_u)

        def mix(old, new):
            return damping * old + (1 - damping) * new

        return (mix(m_from_l, _shift(new_to_r, 0, -1)),
                mix(m_from_r, _shift(new_to_l, 0, 1)),
                mix(m_from_u, _shift(new_to_d, -1, 0)),
                mix(m_from_d, _shift(new_to_u, 1, 0)))

    def bound(msgs):
        """Chain-decomposition dual (the monotone TRW-S bound contract,
        dense_tracking.cpp:1816-1831 / Kolmogorov PAMI 2006 eq. 13): every
        node term split equally between its row chain and its column chain,
        each chain solved exactly by min-sum DP (a sequential loop over the
        columns, then over the rows), the minima summed. Returns [F]."""
        m_l, m_r, m_u, m_d = msgs
        th = 0.5 * (unary + rho * (m_l + m_r + m_u + m_d))
        e_r = (cost_r[:, :, :-1]
               - rho * (m_l[:, :, 1:, None, :] + m_r[:, :, :-1, :, None]))
        e_d = (cost_d[:, :-1]
               - rho * (m_u[:, 1:, :, None, :] + m_d[:, :-1, :, :, None]))
        acc_r = th[:, :, 0]
        for x in range(w - 1):
            acc_r = (acc_r[..., :, None] + e_r[:, :, x]).amin(-2) \
                + th[:, :, x + 1]
        acc_d = th[:, 0]
        for y in range(h - 1):
            acc_d = (acc_d[..., :, None] + e_d[:, y]).amin(-2) + th[:, y + 1]
        return acc_r.amin(-1).sum(-1) + acc_d.amin(-1).sum(-1)

    zero = torch.zeros_like(unary)
    msgs = (zero, zero, zero, zero)
    if approach == 0:
        # TRW-S stopping semantics (dense_tracking.cpp:660-661 feeding
        # MRFEnergy options): iterate until the lower-bound improvement per
        # iteration falls below acc_trws_eps, capped at acc_trws_max_iter;
        # gated on the larger of the bound improvement and the message
        # residual, since the synchronous dual can plateau an iteration or
        # two before the damped messages stop moving. The reported bound is
        # the running max of the dual. One host read of the stop test per
        # iteration; a problem that has stopped keeps its state.
        best = bound(msgs)
        progress = torch.full((nf,), float("inf"), device=unary.device)
        for _ in range(iters):
            live = progress >= eps
            if not bool(live.any()):
                break
            new = iteration(msgs)
            lb = bound(new)
            res = torch.stack([(n - o).abs().amax((1, 2, 3))
                               for n, o in zip(new, msgs)]).amax(0)
            keep = live.view(nf, 1, 1, 1)
            msgs = tuple(torch.where(keep, n, o) for n, o in zip(new, msgs))
            progress = torch.where(live, torch.maximum(lb - best, res),
                                   progress)
            best = torch.where(live, torch.maximum(best, lb), best)
    else:
        # the reference's Minimize_BP runs to m_iterMax regardless of eps
        for _ in range(iters):
            msgs = iteration(msgs)
        best = bound(msgs)

    labels = beliefs(msgs).argmin(-1).to(torch.int32)

    # energy of the final labeling
    lab = labels.long()[..., None]
    e_unary = torch.take_along_dim(unary, lab, -1)[..., 0].sum((1, 2))
    lab_r = _shift(lab, 0, 1)
    lab_d = _shift(lab, 1, 0)
    e_r = torch.take_along_dim(
        torch.take_along_dim(cost_r, lab[..., None], -2)[..., 0, :],
        lab_r, -1)[..., 0]
    e_d = torch.take_along_dim(
        torch.take_along_dim(cost_d, lab[..., None], -2)[..., 0, :],
        lab_d, -1)[..., 0]
    energy = e_unary + e_r[:, :, :-1].sum((1, 2)) + e_d[:, :-1].sum((1, 2))
    if not batched:
        return labels[0], energy[0], best[0]
    return labels, energy, best           # chain-decomposition dual


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

    def edge_cost(dy, dx):
        fb = _shift(flows, dy, dx)
        ob = _shift(occl, dy, dx)
        d = trajectory_distance(flows[:, :, :, :, None], fb[:, :, :, None],
                                method)
        occ_dis = (occl[:, :, :, :, None] != ob[:, :, :, None]).sum(-1)
        sw_pair = sw + _shift(sw, dy, dx)
        return sw_pair[..., None, None] * (beta * d + spatial_occ * occ_dis)

    cost_r, cost_d = edge_cost(0, 1), edge_cost(1, 0)
    if not batched:
        return cost_r[0], cost_d[0]
    return cost_r, cost_d
