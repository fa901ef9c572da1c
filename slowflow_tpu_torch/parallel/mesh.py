"""The jet split over devices (torch port of `slowflow_tpu.parallel.mesh`).

Jets share nothing, so a batch of jet windows splits into one contiguous
chunk per device and each chunk is solved where it lies: pure data
parallelism, the reference's OpenMP-over-jets loop (slow_flow.cpp:706) across
cards. A mesh is an ordered list of `torch.device`s; one device may appear
more than once (two shards on one card, or on the CPU in the tests).

Each shard runs on its own host thread. On CUDA the thread enters
`torch.cuda.device(d)` and a stream of its own before its first launch (the
kernels launch on the thread's current device and stream), waits for the
caller's stream that staged its inputs, and synchronizes its stream before it
hands back its outputs. The outputs are gathered, in order, on the mesh's
first device.

The JAX package's second mesh axis, `sp` (image rows split over devices with
halos), is not ported: ROADMAP Queue 1 keeps it as the last module.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

SP_NOT_PORTED = ("spatial (sp) row-sharding is not ported (ROADMAP Queue 1, "
                 "the sp row-sharding of sharded_jet_step); use n_sp=1")


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
              devices=None) -> list[torch.device]:
    """The ordered devices of a jet split: `devices` (any number of
    entries, repeats allowed), by default every CUDA device torch sees.
    `n_jet`, when given, must equal their number. Raises for a device
    torch cannot see and, with NotImplementedError, for n_sp > 1."""
    if n_sp != 1:
        raise NotImplementedError(SP_NOT_PORTED)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch finds no GPU; pass devices "
                               "(for example ['cpu', 'cpu'])")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [_check_device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices")
    if n_jet is not None and n_jet != len(mesh):
        raise ValueError(f"make_mesh: n_jet {n_jet} != {len(mesh)} devices")
    return mesh


def shard_jet_batch(mesh, *tensors) -> list[tuple]:
    """Split each tensor's batch axis (dim 0) into len(mesh) contiguous
    chunks, chunk i moved to mesh[i]. Returns one tuple of chunks per
    device. The batch must divide evenly."""
    n = len(mesh)
    b = tensors[0].shape[0]
    if any(t.shape[0] != b for t in tensors):
        raise ValueError("shard_jet_batch: batch sizes differ: "
                         f"{[t.shape[0] for t in tensors]}")
    if b % n:
        raise ValueError(f"shard_jet_batch: batch {b} does not split evenly "
                         f"over {n} devices")
    k = b // n
    return [tuple(t[i * k:(i + 1) * k].to(d) for t in tensors)
            for i, d in enumerate(mesh)]


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

    with ThreadPoolExecutor(max_workers=len(mesh)) as ex:
        futures = [ex.submit(work, d, args) for d, args in zip(mesh, shards)]
        outs = [f.result() for f in futures]
    gathered = tuple(torch.cat([o.to(mesh[0]) for o in parts])
                     for parts in zip(*outs))
    # the shards' outputs were made on their own streams and the gather
    # reads them on the caller's: their memory must not be handed out again
    # before it has run
    for o in (o for parts in outs for o in parts if o.device.type == "cuda"):
        o.record_stream(torch.cuda.current_stream(o.device))
    return gathered


def sharded_jet_step(mesh, p):
    """A callable (wx, wy, seq, channel_w, norm_avg, norm_std) ->
    (wx, wy, occ): `compute_one_level` over the batch, split over `mesh`
    (`run_sharded`)."""
    from ..variational.multiframe import compute_one_level

    mesh = make_mesh(devices=mesh)

    def step(wx, wy, seq, channel_w, norm_avg, norm_std):
        return run_sharded(
            mesh, lambda *a: compute_one_level(*a, p=p), wx, wy, seq,
            channel_w, norm_avg, norm_std)
    return step
