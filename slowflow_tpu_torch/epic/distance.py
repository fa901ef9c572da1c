"""Geodesic distance transform with closest-seed labels (torch port of
`slowflow_tpu.epic.distance`).

The distance transform is the JAX package's parallel min-plus relaxation,
batched over images on the device: every pixel takes the per-axis minima of
its neighbours' distances and applies one eikonal quadrant update

  t0 = min(tv, th) + C                           if |tv - th| > C
  t0 = (tv + th + sqrt(2 C^2 - (tv - th)^2)) / 2  otherwise

carrying the closest seed's label along, until nothing changes. The change
is read on the host once per `check_every` iterations (the JAX version
keeps the loop on the device); on CUDA each block of iterations replays a
cached CUDA graph. Seeds are placed on the host, where later
seeds win on collisions as in the reference's loop. The seed adjacency
graph is host numpy and its k-NN search the port's C++ Dijkstra
(slowflow_tpu_torch.native).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..native import knn_graph_all
from ..runtime import device_of
from ..utils.phases import phase
from ..variational import graphs

BIG = 1e18  # stands in for +inf (avoids inf - inf NaNs inside the update)


def _shift_with(x, lab, dy: int, dx: int):
    """out[y, x] = x[y + dy, x + dx] on [B, H, W]; out of range gives
    (BIG, -1)."""
    pad = (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0))
    h, w = x.shape[-2:]
    oy, ox = max(dy, 0), max(dx, 0)
    xs = F.pad(x, pad, value=BIG)[..., oy:oy + h, ox:ox + w]
    ls = F.pad(lab, pad, value=-1)[..., oy:oy + h, ox:ox + w]
    return xs, ls


def _one_iter(cost, dmap, labels):
    tv_a, lv_a = _shift_with(dmap, labels, -1, 0)   # north
    tv_b, lv_b = _shift_with(dmap, labels, 1, 0)    # south
    th_a, lh_a = _shift_with(dmap, labels, 0, -1)   # west
    th_b, lh_b = _shift_with(dmap, labels, 0, 1)    # east
    # t0(tv, th) is monotone in both arguments, so the best of the four
    # quadrant pairs is one update of the per-axis minima
    tv = torch.minimum(tv_a, tv_b)
    lv = torch.where(tv_a < tv_b, lv_a, lv_b)
    th = torch.minimum(th_a, th_b)
    lh = torch.where(th_a < th_b, lh_a, lh_b)
    dt12 = (tv - th).abs()
    tmin = torch.minimum(tv, th)
    lmin = torch.where(tv < th, lv, lh)
    t_quad = torch.sqrt((2 * cost * cost - dt12 * dt12).clamp_min(0.0))
    t0 = torch.where(dt12 > cost, tmin + cost, 0.5 * (tv + th + t_quad))
    t0 = t0.clamp_max(BIG)
    upd = t0 < dmap
    return torch.where(upd, t0, dmap), torch.where(upd, lmin, labels)


def dt_key(cost, seed_dist, seed_labels, check_every: int):
    """The cache key of one distance transform's graphs: the device, the
    inputs' shapes and dtypes and the block length."""
    return ("dt", cost.device, tuple(cost.shape), cost.dtype,
            seed_dist.dtype, seed_labels.dtype, int(check_every))


class _DT(graphs.Segments):
    """distance_transform over a state namespace `st` (cost, dmap, labels)
    in blocks of `check_every` iterations, each a segment that reads
    nothing on the host and ends by marking whether it changed anything,
    which the host reads between blocks (the JAX package's `while_loop`
    around a `fori_loop`)."""

    def __init__(self, st, check_every: int, graphed: bool = False):
        super().__init__(st, graphed)
        self.check_every = check_every

    def block(self):
        st = self.st
        dmap, labels = st.dmap, st.labels
        for _ in range(self.check_every):
            dmap, labels = _one_iter(st.cost, dmap, labels)
        change = torch.where(dmap < st.dmap, (st.dmap - dmap).clamp_max(1e9),
                             torch.zeros((), device=dmap.device)).max()
        st.dmap, st.labels = dmap, labels
        self.mark(change > 0.0)

    def drive(self, run, max_iter: int):
        it = 0
        while it < max_iter:
            run(("block",), self.block)
            it += self.check_every
            if not self.read():
                break


def distance_transform(cost, seed_dist, seed_labels, max_iter: int = 256,
                       check_every: int = 8, *, _eager: bool = False):
    """Parallel geodesic DT of [..., H, W] tensors.

    cost:        per-pixel traversal cost (float32)
    seed_dist:   initial distances (cost at seeds, BIG elsewhere)
    seed_labels: initial labels (int32: seed index at seeds, -1 elsewhere)

    Iterates in blocks of `check_every` until a block changes nothing in any
    image or `max_iter` iterations ran. Returns (dmap, labels).

    On CUDA the blocks replay cached CUDA graphs (`_DT`,
    variational/graphs.py) that every host thread shares, one thread at a
    time, bitwise the eager transform; the CPU runs it eagerly, and so
    does `_eager` (tests and chip_smoke.py only)."""
    graphed = not _eager and cost.device.type == "cuda"
    key = dt_key(cost, seed_dist, seed_labels, check_every)
    with graphs.running(key, cost.device, graphed, shared=True) as prog:
        st = prog.state
        st.cost, st.dmap, st.labels = cost, seed_dist, seed_labels
        if prog.level is None:
            prog.level = _DT(st, check_every, prog.graphed)
        prog.level.drive(prog.run, max_iter)
        if not prog.graphed:
            return st.dmap, st.labels
        return st.dmap.clone(), st.labels.clone()


def seed_graph(labels: np.ndarray, dmap: np.ndarray, ns: int):
    """Seed-adjacency CSR graph from the label borders: the edge between
    labels l0 and l1 weighs the minimum over their border pixel pairs of
    d[p] + d[q]. Returns (indptr, indices, data) of the symmetric CSR."""
    labels = np.asarray(labels)
    dmap = np.asarray(dmap, np.float64)
    pairs = []
    costs = []
    # horizontal borders
    l0 = labels[:, 1:]; l1 = labels[:, :-1]
    m = l0 != l1
    if m.any():
        pairs.append(np.stack([l0[m], l1[m]], 1))
        costs.append((dmap[:, 1:][m] + dmap[:, :-1][m]))
    # vertical borders
    l0 = labels[1:, :]; l1 = labels[:-1, :]
    m = l0 != l1
    if m.any():
        pairs.append(np.stack([l0[m], l1[m]], 1))
        costs.append((dmap[1:, :][m] + dmap[:-1, :][m]))

    if not pairs:
        indptr = np.zeros(ns + 1, np.int32)
        return indptr, np.zeros(0, np.int32), np.zeros(0, np.float32)

    pairs = np.concatenate(pairs, 0)
    costs = np.concatenate(costs, 0)
    valid = (pairs >= 0).all(1)
    pairs = pairs[valid]
    costs = costs[valid]
    lo = pairs.min(1).astype(np.int64)
    hi = pairs.max(1).astype(np.int64)
    key = lo * ns + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    cost_s = costs[order]
    uniq_key, start = np.unique(key_s, return_index=True)
    min_cost = np.minimum.reduceat(cost_s, start)
    lo_u = (uniq_key // ns).astype(np.int32)
    hi_u = (uniq_key % ns).astype(np.int32)

    rows = np.concatenate([lo_u, hi_u])
    cols = np.concatenate([hi_u, lo_u])
    vals = np.concatenate([min_cost, min_cost]).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(ns + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, cols.astype(np.int32), vals


def dist_trf_nnfield_batched(seeds_list, cost_list, nn_list,
                             max_iter: int = 256, device=None):
    """Closest seeds by geodesic distance for B independent (seeds, cost)
    problems of one size: one batched device DT, then per problem the seed
    graph and its k-NN on the host.

    seeds_list: [ns_b, 2] int (x, y); cost_list: [H, W] float32 arrays;
    nn_list: neighbours per seed. `device`: None = CUDA.
    Returns a list of (best [ns, nn], dist [ns, nn], labels, dmap)."""
    out, _ = nnfield_and_labels(seeds_list, cost_list, nn_list, max_iter,
                                device)
    return [(nnf[rows], d0[:, None] + dis[rows], lab, dmap)
            for nnf, dis, rows, d0, lab, dmap in out]


def nnfield_and_labels(seeds_list, cost_list, nn_list, max_iter: int = 256,
                       device=None):
    """`dist_trf_nnfield_batched` before its per-seed gather, and the label
    maps [B, H, W] int32 as the transform left them on `device`.

    Returns (a list of (nnf [ns, nn], dis [ns, nn], rows [ns], d0 [ns],
    labels, dmap) per problem, the label maps): the k-NN of every node of
    the seed graph (node i is seed i), and for each seed the node at its
    pixel and the distance there (a later seed wins a shared pixel), so
    that seed s's neighbours are nnf[rows[s]] at d0[s] + dis[rows[s]]."""
    device = device_of(None, device)
    B = len(seeds_list)
    h, w = np.asarray(cost_list[0]).shape
    costs = np.stack([np.asarray(c, np.float32) for c in cost_list])
    sd = np.full((B, h, w), BIG, np.float32)
    sl = np.full((B, h, w), -1, np.int32)
    sxs, sys = [], []
    for b, seeds in enumerate(seeds_list):
        sx = np.clip(seeds[:, 0].astype(np.int64), 0, w - 1)
        sy = np.clip(seeds[:, 1].astype(np.int64), 0, h - 1)
        # later seeds win on collisions (numpy assigns in order)
        sd[b][sy, sx] = costs[b][sy, sx]
        sl[b][sy, sx] = np.arange(len(seeds), dtype=np.int32)
        sxs.append(sx)
        sys.append(sy)

    with phase("epic.dt_device"):
        dmaps, labels = distance_transform(
            torch.as_tensor(costs, device=device),
            torch.as_tensor(sd, device=device),
            torch.as_tensor(sl, device=device), max_iter)
        dmaps = dmaps.cpu().numpy()
        labels_np = labels.cpu().numpy()
    out = []
    for b in range(B):
        dmap, lab = dmaps[b], labels_np[b]
        ns = len(seeds_list[b])
        with phase("epic.seed_graph"):
            indptr, indices, data = seed_graph(lab, dmap, ns)
        with phase("epic.dijkstra"):
            nnf, dis = knn_graph_all(indptr, indices, data, nn_list[b])
        out.append((nnf, dis, lab[sys[b], sxs[b]], dmap[sys[b], sxs[b]],
                    lab, dmap))
    return out, labels


def dist_trf_nnfield(seeds: np.ndarray, cost: np.ndarray, nn: int,
                     max_iter: int = 256, device=None):
    """Closest seeds of each seed by geodesic distance.

    seeds: [ns, 2] int (x, y); cost: [H, W] float32.
    Returns (best [ns, nn], dist [ns, nn], labels [H, W], dmap [H, W])."""
    return dist_trf_nnfield_batched([seeds], [cost], [nn], max_iter,
                                    device)[0]
