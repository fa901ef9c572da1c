"""Device meshes for the jet split and the row split (torch port of
`slowflow_tpu.parallel.mesh`).

A mesh is n_jet x n_sp devices, row-major (`Mesh`, a list with the sp
extent attached); one device may appear more than once (two shards on one
card, or CPU entries in the tests).

`jet` axis: jets share nothing, so a batch of jet windows splits into one
contiguous chunk per mesh row and each chunk is solved where it lies: pure
data parallelism, the reference's OpenMP-over-jets loop (slow_flow.cpp:706)
across cards (`run_sharded`). Each shard runs on its own host thread, the
same one for a mesh position from call to call, since the level's CUDA
graphs are cached per host thread (variational/graphs.py). On
CUDA the thread enters `torch.cuda.device(d)` and a stream of its own before
its first launch (the kernels launch on the thread's current device and
stream), waits for the caller's stream that staged its inputs, and
synchronizes its stream before it hands back its outputs. The outputs are
gathered, in order, on the mesh's first device.

`sp` axis: each jet's image rows split into n_sp contiguous strips over a
mesh row, each computed on a window with ghost rows that the level
refreshes from their owners (parallel/strips.py). The JAX package leaves
the halos to XLA and pins its slowest route for it; here every route runs
on its own kernels. `sharded_jet_step(mesh, p, spatial_shard=True)` is that
path, for one level, as in the JAX package.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .strips import run_strips, strip_bounds


class Mesh(list):
    """The devices of an n_jet x n_sp mesh, row-major: row j holds jet
    chunk j's strips."""

    def __init__(self, devices, n_sp: int = 1):
        super().__init__(devices)
        self.n_sp = n_sp

    @property
    def n_jet(self) -> int:
        return len(self) // self.n_sp

    @property
    def shape(self) -> dict:
        return {"jet": self.n_jet, "sp": self.n_sp}


def _check_device(d) -> torch.device:
    """`d` as a torch.device that torch can see; raises otherwise."""
    d = torch.device(d)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"mesh device {d}: only cuda and cpu are supported")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {d}: torch finds no GPU")
    index = torch.cuda.current_device() if d.index is None else d.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"mesh device {d}: torch sees "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def make_mesh(n_jet: int | None = None, n_sp: int = 1,
              devices=None) -> Mesh:
    """An n_jet x n_sp mesh over `devices` (row-major, repeats allowed), by
    default every CUDA device torch sees; n_jet defaults to their number
    over n_sp, and n_jet x n_sp must equal it. Raises for a device torch
    cannot see."""
    if n_sp < 1:
        raise ValueError(f"make_mesh: n_sp {n_sp} < 1")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch finds no GPU; pass devices "
                               "(for example ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [_check_device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices")
    n_jet = len(mesh) // n_sp if n_jet is None else n_jet
    if n_jet * n_sp != len(mesh):
        raise ValueError(f"make_mesh: n_jet {n_jet} x n_sp {n_sp} != "
                         f"{len(mesh)} devices")
    return Mesh(mesh, n_sp)


def shard_jet_batch(mesh, *tensors, spatial_axis: int | None = None
                    ) -> list[tuple]:
    """Split each tensor's batch axis (dim 0) into one contiguous chunk per
    mesh row; with `spatial_axis` and an sp extent > 1 also split that axis
    into the row's n_sp contiguous strips (`strips.strip_bounds`), else each
    row's chunk is repeated over its sp entries. Returns one tuple per mesh
    entry (row-major), moved to its device. The batch must divide evenly."""
    n_sp = getattr(mesh, "n_sp", 1)
    n = len(mesh) // n_sp
    b = tensors[0].shape[0]
    if any(t.shape[0] != b for t in tensors):
        raise ValueError("shard_jet_batch: batch sizes differ: "
                         f"{[t.shape[0] for t in tensors]}")
    if b % n:
        raise ValueError(f"shard_jet_batch: batch {b} does not split evenly "
                         f"over {n} devices")
    k = b // n
    out = []
    for i, d in enumerate(mesh):
        j, s = divmod(i, n_sp)
        parts = []
        for t in tensors:
            t = t[j * k:(j + 1) * k]
            if spatial_axis is not None and n_sp > 1:
                bounds = strip_bounds(t.shape[spatial_axis], n_sp)
                t = t.narrow(spatial_axis, bounds[s],
                             bounds[s + 1] - bounds[s])
            parts.append(t.to(d))
        out.append(tuple(parts))
    return out


# one host thread per mesh position (and per rank of the row split), kept
# from call to call
_WORKERS: dict = {}
_workers_lock = threading.Lock()


def _worker(i: int, kind: str = "shard") -> ThreadPoolExecutor:
    with _workers_lock:
        if (kind, i) not in _WORKERS:
            _WORKERS[kind, i] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"{kind}{i}")
        return _WORKERS[kind, i]


def run_sharded(mesh, fn, *tensors):
    """fn(*chunk) for each device's chunk of the batch (`shard_jet_batch`),
    each on its own host thread (on CUDA inside `torch.cuda.device(d)` on a
    stream of its own); fn returns a tuple of [b, ...] tensors. `mesh` is
    `make_mesh`'s. Returns those tuples' entries concatenated in mesh order
    on mesh[0]."""
    shards = shard_jet_batch(mesh, *tensors)
    # the caller's current stream on each card staged the chunks
    callers = {d: torch.cuda.current_stream(d) for d in set(mesh)
               if d.type == "cuda"}

    def work(d, args):
        if d.type != "cuda":
            return fn(*args)
        with torch.cuda.device(d):
            stream = torch.cuda.Stream(d)
            stream.wait_stream(callers[d])
            with torch.cuda.stream(stream):
                out = fn(*args)
            stream.synchronize()
            return out

    futures = [_worker(i).submit(work, d, args)
               for i, (d, args) in enumerate(zip(mesh, shards))]
    outs = [f.result() for f in futures]
    gathered = tuple(torch.cat([o.to(mesh[0]) for o in parts])
                     for parts in zip(*outs))
    # the shards' outputs were made on their own streams and the gather
    # reads them on the caller's: their memory must not be handed out again
    # before it has run
    for o in (o for parts in outs for o in parts if o.device.type == "cuda"):
        o.record_stream(torch.cuda.current_stream(o.device))
    return gathered


def sharded_jet_step(mesh, p, spatial_shard: bool = False):
    """A callable (wx, wy, seq, channel_w, norm_avg, norm_std) ->
    (wx, wy, occ): one `compute_one_level` pass over the batch with the
    jets split over the mesh's rows and, with `spatial_shard` on a mesh of
    sp extent > 1, each jet's image rows over the row's devices
    (`strips.run_strips`); without it the jets split over the mesh's first
    column (`run_sharded`). `mesh`: a `make_mesh` mesh, or a list of
    devices (one row each). Inputs are full [B, ...] tensors; the result
    lands on mesh[0]."""
    from ..variational.multiframe import compute_one_level

    if not isinstance(mesh, Mesh):
        mesh = make_mesh(devices=mesh)

    def step(wx, wy, seq, channel_w, norm_avg, norm_std):
        if spatial_shard and mesh.n_sp > 1:
            return run_strips(mesh, p, wx, wy, seq, channel_w, norm_avg,
                              norm_std)[0]
        return run_sharded(
            mesh[::mesh.n_sp], lambda *a: compute_one_level(*a, p=p), wx, wy,
            seq, channel_w, norm_avg, norm_std)
    return step
