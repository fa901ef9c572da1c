"""CUDA graphs of the jet solve's pyramid levels: the port's counterpart of
the JAX package's compiled dispatch (its `jax.jit` of the pyramid).

`multiframe.compute_one_level` cuts a level into segments that read nothing
on the host (the start, the alternation top, one outer iteration, one inner
iteration, the outer tail, the alternation end). On CUDA each segment of a
level shape is captured once into a `torch.cuda.CUDAGraph` and then
replayed; the host reads the loop-exit flag that the segment wrote between
replays, where the eager level reads `live.any()`, so every exit falls
where it falls eagerly and the result is bitwise the eager one.

A `Program` holds one level shape's graphs over fixed memory: its inputs
and its state live in `Slots`, whose tensors keep their addresses, and a
segment ends by copying what it changed into them. The first time a
segment runs it runs eagerly on a side stream (this step's work; nvcc
builds, library loads, plan caches and per-device limits all happen here,
outside any capture), then it is captured with capture_error_mode
"thread_local", since other host threads (the stage-2 CLI's EPIC
prefetch, the shards of `parallel.mesh.run_sharded`) launch meanwhile.
Kernel wrappers count their launches into the graph's record at capture
(`kernels.recording`); each replay adds the record to `kernels.LAUNCHES`.

Programs are cached per host thread, keyed by `level_key`, at most
MAX_PROGRAMS per thread (least recently used dropped first). A failed
capture or replay raises; nothing falls back to the eager level.
"""
from __future__ import annotations

import collections
import threading
import time

import torch

from .. import kernels

MAX_PROGRAMS = 16   # level shapes kept per host thread

_local = threading.local()
_stats_lock = threading.Lock()
# captures and replays of every thread, and the seconds spent in first runs
# (warm-up and capture)
STATS = {"captures": 0, "replays": 0, "capture_s": 0.0}


def _add_stat(key: str, value) -> None:
    with _stats_lock:
        STATS[key] += value


def reset_stats() -> None:
    with _stats_lock:
        STATS.update(captures=0, replays=0, capture_s=0.0)


def level_key(device, p, b: int, h: int, w: int, first_system: bool):
    """The cache key of one level shape: device, params (a frozen
    dataclass, so hashable), their route, the batch and image size, and
    whether the alternation top assembles and solves a first system."""
    return (torch.device(device), p, p.route(), b, h, w, bool(first_system))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return tuple(_clone(v) for v in x)


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)


class Slots:
    """Named device tensors (or tuples / dicts of them) that keep their
    memory: assigning to a name that exists copies into its tensors, so a
    graph captured over them reads and writes the same addresses on every
    replay. A new name takes a copy of its first value, which must happen
    outside a capture (a segment's first, eager run)."""

    def __setattr__(self, name, value):
        slots = self.__dict__
        if name in slots:
            _copy_into(slots[name], value)
        elif torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"slot {name!r} first assigned inside a CUDA "
                               "graph capture")
        else:
            slots[name] = _clone(value)


class Program:
    """One level shape's graphs: `inputs` and `state` are its Slots, `run`
    replays a segment's graph, capturing it on the segment's first run."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.inputs = Slots()
        self.state = Slots()
        self.graphs: dict = {}
        self.level = None     # the segments' owner, set by the caller
        self._side = torch.cuda.Stream(self.device)

    def run(self, segment, fn) -> None:
        """fn() as a graph: replayed if `segment` was captured, else run
        eagerly on the side stream and then captured."""
        entry = self.graphs.get(segment)
        if entry is not None:
            graph, counts = entry
            graph.replay()
            kernels.add_launches(counts)
            _add_stat("replays", 1)
            return
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._side):
            fn()
            with kernels.recording() as counts:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass      # the capture was invalidated; fn's error
                    raise
                graph.capture_end()
        current.wait_stream(self._side)
        self.graphs[segment] = (graph, counts)
        _add_stat("captures", 1)
        _add_stat("capture_s", time.perf_counter() - t0)

    def close(self) -> None:
        """Free the graphs and slots once the device has run them."""
        torch.cuda.synchronize(self.device)
        for graph, _ in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.inputs = self.state = self.level = None


def _cache() -> collections.OrderedDict:
    cache = getattr(_local, "programs", None)
    if cache is None:
        cache = _local.programs = collections.OrderedDict()
    return cache


def program(key, build) -> Program:
    """This thread's Program for `key`, made by `build()` if missing."""
    cache = _cache()
    prog = cache.get(key)
    if prog is not None:
        cache.move_to_end(key)
        return prog
    while len(cache) >= MAX_PROGRAMS:
        cache.popitem(last=False)[1].close()
    prog = cache[key] = build()
    return prog


def discard(key) -> None:
    """Drop this thread's Program for `key` (after a failed run, whose
    state is unknown)."""
    prog = _cache().pop(key, None)
    if prog is not None:
        prog.close()


def clear() -> None:
    """Drop every Program of this thread."""
    cache = _cache()
    while cache:
        cache.popitem()[1].close()


def cached_keys() -> list:
    return list(_cache())
