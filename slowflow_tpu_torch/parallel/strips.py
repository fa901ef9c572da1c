"""Image rows split over devices: the `sp` axis of `sharded_jet_step`.

Each jet's image rows [0, H) split into n_sp contiguous strips; strip k owns
rows [s_k, s_{k+1}), s_k = k H // n_sp. A strip computes on a window: its own
rows and `ghost` rows on each side, a real slice of the image clipped at its
edges. Every window of a plan has the same height (the top window reaches
further down, the bottom one further up) and holds no padding rows, so one
device's windows ride the batch axis as [E, ..., H_win, W] (E = its (jet,
strip) entries, jet-major) and each kernel makes one launch per device. The
kernels take the windows' places as `StripRows`: the image row of each
window's first row (the red-black colour and the warp's clamp and mask follow
the image's rows) and each window's own rows (K1's change sums count only
those).

Between two exchange points the level runs inside each window unchanged.
Near a window edge that is not an image edge, values are wrong (derivative
taps and solver neighbours read clamped rows there), and the error moves
inward. `ghost` is the depth of that cone plus the warp's reach, so own rows
come out bitwise as on the whole image (`cone_rows`):
  solve  2 n + 3 rows for n SOR sweeps: a row's data system reads the warped
         frames 4 rows away (5-tap derivatives of 5-tap derivatives), and the
         2 n half-sweeps carry a row's coefficients 2 n - 1 rows (the first
         half-sweep reads only the start, which is exact); the smoothness
         weights, the Laplacian RHS and dpsis read less far;
  ICM    2 k + 3 rows for k sweeps: the occlusion costs read 2 rows away (a
         derivative of the temporal difference), the first start's labels
         move one row a half-sweep, and the energy's vertical pairs read one
         row below the own rows;
  warp   ceil(ref max|wy|) rows beyond the cone: the farthest row that a
         bilinear sample with a nonzero weight reads.
Ghost rows are refreshed from their owners at two exchange points: after
each solve (du, dv: the flow and the next inner solve's start are pointwise
in them) and after each relabel (occ). Per-jet scalars are summed over own
rows, then over a jet's strips in strip order; host flags are ORed over
every device. Before each warp `cover` reads max|wy| and, when the flow has
outgrown the windows, widens every window from the owners of its rows.

A device's share is a `Strips`; with several devices each runs on a host
thread of its own, the same one from call to call, and the collectives meet
at a barrier. Without a plan (`strips=None`) the level pays nothing.

On CUDA the level with strips replays CUDA graphs (variational/
multiframe.py, variational/graphs.py), one Program per window geometry, so
a `Strips` never changes: `cover` hands back the Geometry of the wider
windows, and a Program keeps the Strips whose tables its graphs read, lent
to each later call's plan (`rejoin`). With one rank every collective is
device work and a segment captures whole. With several, the collectives'
host work (the syncs, the allgathers, the copies between devices) is a
`graphs.host_step`, where a capture is cut, and the exchange counter a
`graphs.count`, which each replay runs. The ranks' threads run nothing
else and take the calls in one order, so their Programs are made,
replayed and dropped in the same order and every rank captures, and cuts,
at the same points.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from concurrent.futures import wait
from dataclasses import dataclass

import numpy as np
import torch

from ..core.rows import StripRows, own_rows
from ..variational import graphs


def strip_bounds(h: int, n_sp: int) -> list[int]:
    """The first row of each strip, and h."""
    return [k * h // n_sp for k in range(n_sp + 1)]


def cone_rows(p) -> int:
    """Rows from a window edge that one pass between two exchanges can
    corrupt (module docstring), without the warp's reach."""
    g = 2 * p.niter_solver + 3
    if p.occlusion_reasoning and not p.one_direction and p.niter_alter > 1:
        g = max(g, 2 * p.niter_graphc + 3)
    return g


def reach_rows(p, max_wy: float) -> int:
    """Rows beyond a row that its warp reads with a nonzero weight."""
    return math.ceil(p.ref * max_wy)


@dataclass(frozen=True)
class Geometry:
    """The windows of one plan: own rows `bounds`, window height `win_h`,
    each window's first image row `starts`."""

    img_h: int
    n_sp: int
    ghost: int

    @property
    def bounds(self) -> list[int]:
        return strip_bounds(self.img_h, self.n_sp)

    @property
    def win_h(self) -> int:
        b = self.bounds
        own = max(b[k + 1] - b[k] for k in range(self.n_sp))
        return min(self.img_h, own + 2 * self.ghost)

    @property
    def starts(self) -> list[int]:
        b, hw = self.bounds, self.win_h
        return [min(max(b[k] - self.ghost, 0), self.img_h - hw)
                for k in range(self.n_sp)]

    def owner(self, y: np.ndarray) -> np.ndarray:
        """The strip that owns each image row of `y`."""
        return np.searchsorted(np.asarray(self.bounds[1:]), y, side="right")


class _Group:
    """The host threads of one plan (one per device) and their meeting
    point. With one member every collective is local."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def allgather(self, rank: int, obj) -> list:
        if self.n == 1:
            return [obj]
        self.slots[rank] = obj
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _strip_total(parts: torch.Tensor) -> torch.Tensor:
    """[B, n_sp, ...] partials -> [B, ...] totals, added in strip order."""
    total = parts[:, 0]
    for s in range(1, parts.shape[1]):
        total = total + parts[:, s]
    return total


def _take(x, e, r):
    """Rows r of windows e of x [E, ..., H_win, W]: [n, ..., W]."""
    return x.movedim(-2, 1)[e, r]


def _put(x, e, r, v) -> None:
    x.movedim(-2, 1)[e, r] = v


class StripPlan:
    """The strips of a [B, ..., H, W] level over devices: entry g = b n_sp + s
    (jet b, strip s) lies on `placement[g]`; devices are ranked in order of
    first appearance and each rank holds its entries jet-major."""

    def __init__(self, p, b: int, h: int, n_sp: int, placement, max_wy=0.0):
        if not 1 <= n_sp <= h:
            raise ValueError(f"{n_sp} strips of {h} rows")
        if len(placement) != b * n_sp:
            raise ValueError(f"{len(placement)} places for {b} jets x "
                             f"{n_sp} strips")
        self.p, self.b, self.img_h, self.n_sp = p, b, h, n_sp
        self.cone = cone_rows(p)
        placement = [torch.device(d) for d in placement]
        self.devices = list(dict.fromkeys(placement))
        self.local = [[g for g, d in enumerate(placement) if d == dev]
                      for dev in self.devices]
        self.geometry = Geometry(h, n_sp, self.cone + reach_rows(p, max_wy))
        self.group = _Group(len(self.devices))
        self.exchanges = 0     # exchange points passed (rank 0 counts)
        self.widenings = 0

    def moves(self, old: Geometry, new: Geometry, ghosts_only: bool) -> dict:
        """(src rank, dst rank) -> local (src entries, src rows, dst entries,
        dst rows) that fill the windows of `new` (only their ghost rows with
        `ghosts_only`) from the own rows of the windows of `old`."""
        pos = {g: (r, i) for r, gs in enumerate(self.local)
               for i, g in enumerate(gs)}
        parts: dict = {}
        for s in range(self.n_sp):
            y = new.starts[s] + np.arange(new.win_h)
            t = old.owner(y)
            keep = t != s if ghosts_only else np.ones_like(t, bool)
            y, t, dst_r = y[keep], t[keep], np.arange(new.win_h)[keep]
            src_r = y - np.asarray(old.starts)[t]
            for b in range(self.b):
                dr, de = pos[b * self.n_sp + s]
                for u in np.unique(t):
                    sel = t == u
                    sr, se = pos[b * self.n_sp + u]
                    parts.setdefault((sr, dr), []).append(
                        (np.full(sel.sum(), se), src_r[sel],
                         np.full(sel.sum(), de), dst_r[sel]))
        return {k: tuple(np.concatenate(c) for c in zip(*v))
                for k, v in parts.items()}

    def windows(self, rank: int, x: torch.Tensor,
                rows_dim: int | None = -2) -> torch.Tensor:
        """Rank `rank`'s windows of a full [B, ...] tensor (rows at
        `rows_dim`; None: per-jet values, no rows) on its device."""
        geo, dev = self.geometry, self.devices[rank]
        parts = []
        for g in self.local[rank]:
            b, s = divmod(g, self.n_sp)
            t = x[b]
            if rows_dim is not None:
                t = t.narrow(rows_dim, geo.starts[s], geo.win_h)
            parts.append(t)
        return torch.stack(parts).to(dev).contiguous()

    def assemble(self, outs: list, device) -> torch.Tensor:
        """The full [B, H, W] tensor on `device` from each rank's [E, H_win,
        W] windows, own rows only."""
        geo = self.geometry
        b_, w = self.b, outs[0].shape[-1]
        full = torch.empty((b_, self.img_h, w), dtype=outs[0].dtype,
                           device=device)
        bounds = geo.bounds
        for rank, win in enumerate(outs):
            for i, g in enumerate(self.local[rank]):
                b, s = divmod(g, self.n_sp)
                lo = bounds[s] - geo.starts[s]
                full[b, bounds[s]:bounds[s + 1]] = \
                    win[i, lo:lo + bounds[s + 1] - bounds[s]].to(device)
        return full


class Strips:
    """One device's share of a `StripPlan` (rank `rank`) and the exchanges
    and reductions of `compute_one_level` over it."""

    def __init__(self, plan: StripPlan, rank: int,
                 geometry: Geometry | None = None):
        self.plan, self.rank = plan, rank
        self.device = plan.devices[rank]
        self.entries = plan.local[rank]
        self.img_h = plan.img_h
        geo = self.geometry = geometry or plan.geometry
        n = plan.n_sp
        table = []
        for g in self.entries:
            s = g % n
            lo = geo.bounds[s] - geo.starts[s]
            table.append((geo.starts[s], lo,
                          lo + geo.bounds[s + 1] - geo.bounds[s]))
        self.table = tuple(table)

    # The device tables are made on first use, in a segment's eager run
    # (never in a capture), and then kept: a Strips that a Program's kept
    # one stands in for uploads nothing.
    @functools.cached_property
    def jets(self) -> torch.Tensor:
        return torch.tensor([g // self.plan.n_sp for g in self.entries],
                            device=self.device)

    @functools.cached_property
    def rows(self) -> StripRows:
        return StripRows(torch.tensor(self.table, dtype=torch.int32,
                                      device=self.device), self.img_h)

    @functools.cached_property
    def own(self) -> torch.Tensor:
        return own_rows(self.rows, self.geometry.win_h)

    @functools.cached_property
    def _ghost_moves(self) -> dict:
        return self._to_device(self.plan.moves(self.geometry, self.geometry,
                                               ghosts_only=True))

    def key(self) -> tuple:
        """What fixes this rank's windows and collectives: the image
        height, the strips, the ghost depth and window height, the rank,
        the ranks' devices and entries, and each window's (start, lo, hi)
        rows."""
        plan, geo = self.plan, self.geometry
        return (plan.img_h, plan.n_sp, geo.ghost, geo.win_h, self.rank,
                tuple(map(str, plan.devices)),
                tuple(map(tuple, plan.local)), self.table)

    def rejoin(self, plan: StripPlan) -> "Strips":
        """These windows (kept by a Program from an earlier call of the same
        key) with the collectives and counters of `plan`."""
        self.plan = plan
        return self

    def widened(self, geometry: Geometry) -> "Strips":
        """This rank's share of the plan in the windows of `geometry`."""
        return Strips(self.plan, self.rank, geometry)

    def _to_device(self, moves: dict) -> dict:
        return {k: tuple(torch.as_tensor(a, device=self.plan.devices[
            k[0] if i < 2 else k[1]]) for i, a in enumerate(v))
            for k, v in moves.items()}

    def _move(self, moves: dict, srcs, dsts) -> None:
        """dsts[i] rows <- srcs[i] rows along `moves` (every rank calls)."""
        me = self.rank
        send = {dr: [_take(x, m[0], m[1]) for x in srcs]
                for (sr, dr), m in moves.items() if sr == me and dr != me}
        local = moves.get((me, me))
        if local is not None:
            for x, y in zip(srcs, dsts):
                _put(y, local[2], local[3], _take(x, local[0], local[1]))
        if self.plan.group.n > 1:
            graphs.host_step(lambda: self._swap(moves, send, dsts))

    def _swap(self, moves: dict, send: dict, dsts) -> None:
        """`_move`'s collective: every rank's rows for the others, then
        this rank's share of them into `dsts`."""
        me, group = self.rank, self.plan.group
        _sync(self.device)
        inbox = group.allgather(me, send)
        for q, box in enumerate(inbox):
            if q != me and me in box:
                m = moves[(q, me)]
                for y, v in zip(dsts, box[me]):
                    _put(y, m[2], m[3], v.to(self.device))
        _sync(self.device)
        group.barrier.wait()

    def exchange(self, *ts: torch.Tensor) -> None:
        """Refresh the ghost rows of [E, ..., H_win, W] tensors in place
        from their owners."""
        self._move(self._ghost_moves, ts, ts)
        graphs.count(self._count_exchange)

    def _count_exchange(self) -> None:
        if self.rank == 0:
            self.plan.exchanges += 1

    def any(self, flag: torch.Tensor) -> bool:
        """flag.any() over every device's entries (a host read)."""
        return any(self.plan.group.allgather(self.rank, bool(flag.any())))

    def own_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-entry sums of [E, ..., H_win, W] over own rows: [E, ...]."""
        own = self.own.view(-1, *([1] * (x.dim() - 3)), *self.own.shape[1:])
        return torch.where(own, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).sum((-2, -1))

    def jet_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-entry partials [E, ...] -> their jet's total over its strips
        (in strip order), per entry."""
        plan = self.plan
        if plan.group.n == 1:
            total = _strip_total(x.view(plan.b, plan.n_sp, *x.shape[1:]))
        else:
            total = graphs.host_step(lambda: self._gathered_total(x))
        return total[self.jets]

    def _gathered_total(self, x: torch.Tensor) -> torch.Tensor:
        """`jet_sum`'s collective: every jet's total on this device."""
        plan = self.plan
        every = plan.group.allgather(self.rank, x.cpu())
        full = torch.empty((plan.b * plan.n_sp, *x.shape[1:]), dtype=x.dtype)
        for r, part in enumerate(every):
            full[plan.local[r]] = part
        return _strip_total(full.view(plan.b, plan.n_sp,
                                      *x.shape[1:])).to(self.device)

    def cover(self, wy: torch.Tensor, *ts: torch.Tensor):
        """None while the windows hold every row the warp by `wy` reads
        with a nonzero weight; else every window is widened to just cover
        it, and the widened copies of the [E, ..., H_win, W] tensors `ts`
        are returned with the wider windows' Geometry."""
        plan, old = self.plan, self.geometry
        m = max(plan.group.allgather(self.rank, float(wy.abs().amax())))
        need = plan.cone + reach_rows(plan.p, m)
        if need <= old.ghost or old.win_h == plan.img_h:
            return None
        new = Geometry(plan.img_h, plan.n_sp, need)
        moves = self._to_device(plan.moves(old, new, ghosts_only=False))
        outs = [x.new_empty((*x.shape[:-2], new.win_h, x.shape[-1]))
                for x in ts]
        self._move(moves, ts, outs)
        if self.rank == 0:
            plan.geometry = new
            plan.widenings += 1
        return outs, new


# A call's ranks meet at barriers, so every rank's worker thread must take
# the calls in one order: two callers whose ranks were queued in different
# orders would each wait for a rank queued behind the other's.
_submit_lock = threading.Lock()


def run_strips(mesh, p, wx, wy, seq, channel_w, norm_avg, norm_std):
    """`compute_one_level` with the jets split over the mesh's rows and
    each jet's image rows over its columns (`mesh` is a `make_mesh` mesh,
    n_jet x n_sp). Inputs are the full [B, ...] tensors on any device; the
    result (wx, wy, occ) [B, H, W] lands on mesh[0]. Returns the outputs
    and the plan (its exchanges and widenings)."""
    from ..runtime import on_device
    from ..variational.multiframe import compute_one_level
    from .mesh import _worker

    b, _, _, h, _ = seq.shape
    n_jet, n_sp = mesh.n_jet, mesh.n_sp
    if b % n_jet:
        raise ValueError(f"batch of {b} jets does not split evenly over "
                         f"{n_jet} mesh rows")
    per = b // n_jet
    placement = [mesh[(g // n_sp // per) * n_sp + g % n_sp]
                 for g in range(b * n_sp)]
    plan = StripPlan(p, b, h, n_sp, placement,
                     max_wy=float(wy.abs().amax()))

    def work(rank):
        try:
            return solve(rank)
        except BaseException:
            plan.group.barrier.abort()     # the other ranks stop waiting
            raise

    def solve(rank):
        dev = plan.devices[rank]
        with on_device(dev):
            stream = torch.cuda.Stream(dev) if len(plan.devices) > 1 \
                and dev.type == "cuda" else None
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                args = [plan.windows(rank, t) for t in (wx, wy, seq,
                                                        channel_w)]
                args += [plan.windows(rank, t, None)
                         for t in (norm_avg, norm_std)]
                out = compute_one_level(*args, p=p,
                                        strips=Strips(plan, rank))
            if stream is not None:
                stream.synchronize()
            return out

    if len(plan.devices) == 1:
        outs = [work(0)]
    else:
        with _submit_lock:
            futures = [_worker(r, "strip-rank").submit(work, r)
                       for r in range(len(plan.devices))]
        wait(futures)
        # the rank that failed first, not one that found the barrier broken
        errors = [e for e in (f.exception() for f in futures) if e]
        errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        if errors:
            raise errors[0]
        outs = [f.result() for f in futures]
    out = tuple(plan.assemble([o[i] for o in outs], mesh[0])
                for i in range(3))
    return out, plan

