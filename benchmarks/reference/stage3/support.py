"""What the reference's stage-3 modules take from elsewhere, written here:
tensor conversion in the compute dtype, the eager stand-in of the port's
segment runner, the blocks of grid rows that the per-pixel steps run over,
small-segment removal, and the seed graph's k nearest nodes by shortest
path (Dijkstra in lockstep over every source, on the device)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def as_float(x, device) -> torch.Tensor:
    """A contiguous tensor on `device` in torch's default float dtype
    (float32; bfloat16 while the control runs)."""
    dtype = torch.get_default_dtype()
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                           device=device).to(dtype)


@contextlib.contextmanager
def phase(name: str):
    yield


class Segments:
    """A computation cut into segments: a segment marks per-item live
    flags, the host loop reads whether any is live."""

    def __init__(self, st):
        self.st = st
        self.marked = None

    def mark(self, live):
        self.marked = live

    def read(self) -> bool:
        return bool(self.marked.any())

    @staticmethod
    def run(segment, fn) -> None:
        fn()


# elements of the largest intermediate that one block of grid rows of a
# per-pixel step may build (2^28 float32: 1 GiB)
BLOCK_ELEMENTS = 1 << 28


def row_blocks(h: int, per_row: int) -> list[slice]:
    """Blocks of the h grid rows for a per-pixel step whose largest
    intermediate holds `per_row` elements a row: as many rows a block as
    BLOCK_ELEMENTS allows, at least one. Steps whose reductions run over
    the hypotheses, frames and channels of a pixel alone give, block by
    block, the whole grid's values bit for bit, and at the published scale
    they fit beside the bank."""
    rows = max(1, BLOCK_ELEMENTS // max(per_row, 1))
    return [slice(r, min(r + rows, h)) for r in range(0, h, rows)]


def remove_small_segments(F: np.ndarray, min_size: int) -> None:
    """Zero, in place, every 4-connected component of equal values of the
    integer map F that has fewer than `min_size` pixels (labels by
    min-index flooding with pointer jumping)."""
    t = torch.as_tensor(np.asarray(F, np.int64))
    h, w = t.shape
    idx = torch.arange(h * w).view(h, w)
    lab = idx.clone()
    big = h * w
    while True:
        new = lab
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            cand = torch.full_like(lab, big)
            same = t[yd, xd] == t[ys, xs]
            cand[yd, xd] = torch.where(same, lab[ys, xs], big)
            new = torch.minimum(new, cand)
        new = new.flatten()[new.flatten()].view(h, w)   # pointer jumping
        if torch.equal(new, lab):
            break
        lab = new
    sizes = torch.bincount(lab.flatten(), minlength=h * w)
    small = (sizes[lab] < min_size).numpy()
    F[small] = 0


def knn_shortest_paths(indptr, indices, data, k: int, device):
    """The k nearest nodes of every node of an undirected CSR graph by
    shortest path, the node itself first, and their distances (float32
    sums along the path); unfilled slots are -1 / +inf. Every source runs
    Dijkstra at once: each step settles, per source, its unsettled node of
    least tentative distance (the lowest index on a tie) and relaxes that
    node's edges. A source keeps one (node, distance) entry for each
    relaxation it made, so a step looks only at the nodes that its source
    has reached: a node's least entry is its tentative distance, and the
    entries of a settled node are set aside."""
    indptr = np.asarray(indptr, np.int64)
    ns = len(indptr) - 1
    best = np.full((ns, k), -1, np.int32)
    dist = np.full((ns, k), np.inf, np.float32)
    if ns == 0:
        return best, dist
    deg = np.diff(indptr)
    maxdeg = max(int(deg.max()), 1)
    nbr = np.full((ns, maxdeg), -1, np.int64)
    wts = np.full((ns, maxdeg), np.inf, np.float32)
    pos = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
    rows = np.repeat(np.arange(ns), deg)
    nbr[rows, pos] = np.asarray(indices, np.int64)
    wts[rows, pos] = np.asarray(data, np.float32)
    nbr = torch.as_tensor(nbr, device=device)
    wts = torch.as_tensor(wts, device=device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    steps = min(k, ns)
    width = 1 + steps * maxdeg            # the entries a source can make
    chunk = max(1, BLOCK_ELEMENTS // width)
    for s0 in range(0, ns, chunk):
        src = torch.arange(s0, min(ns, s0 + chunk), device=device)
        n = len(src)
        node = torch.full((n, width), -1, dtype=torch.int64, device=device)
        node[:, 0] = src
        dd = torch.full((n, width), float("inf"), dtype=torch.float32,
                        device=device)
        dd[:, 0] = 0.0
        done = torch.zeros((n, width), dtype=torch.bool, device=device)
        settled = torch.full((n, steps), -1, dtype=torch.int64,
                             device=device)
        bo, do = [], []
        for i in range(steps):
            m = 1 + i * maxdeg                # entries made so far
            e = torch.where(done[:, :m], inf, dd[:, :m])
            du = e.min(1).values
            ok = torch.isfinite(du)
            u = torch.where((e == du[:, None]) & ok[:, None], node[:, :m],
                            ns).min(1).values
            u = torch.where(ok, u, -1)
            bo.append(u)
            do.append(du)
            settled[:, i] = u
            done[:, :m] |= node[:, :m] == u[:, None]
            nv, nw = nbr[u.clamp_min(0)], wts[u.clamp_min(0)]
            live = (nv >= 0) & ok[:, None]
            node[:, m:m + maxdeg] = torch.where(live, nv, -1)
            dd[:, m:m + maxdeg] = torch.where(live, du[:, None] + nw, inf)
            done[:, m:m + maxdeg] = (nv[:, :, None]
                                     == settled[:, None, :i + 1]).any(-1)
        best[s0:s0 + n, :len(bo)] = torch.stack(bo, 1).cpu().numpy()
        dist[s0:s0 + n, :len(do)] = torch.stack(do, 1).cpu().numpy()
    return best, dist
