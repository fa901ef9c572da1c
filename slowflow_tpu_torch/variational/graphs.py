"""CUDA graphs of the port's compiled programs: its counterpart of the JAX
package's compiled dispatch (its `jax.jit` of the pyramid, of stage 3's
propagation, selection and solve, and of the EPIC distance transform).

A caller cuts its work into segments that read nothing on the host (the
jet solve's level in `multiframe._Level`; stage 3's alternation in
`tracking.driver._Alternation`, its TRW / BP solve in `tracking.mrf._Solve`;
the distance transform's blocks in `epic.distance._DT`). On CUDA each
segment of a shape is captured once into a `torch.cuda.CUDAGraph` and then
replayed; the host reads the loop-exit flag that the segment wrote between
replays, where the eager code reads `live.any()`, so every exit falls where
it falls eagerly and the result is bitwise the eager one.

A `Program` holds one shape's graphs over fixed memory: its inputs and its
state live in `Slots`, whose tensors keep their addresses, and a segment
ends by copying what it changed into them. All graphs of a Program share
one memory pool: they replay one at a time on one stream and keep nothing
of their own between replays (what lasts is in the Slots), so one
segment's temporaries may take another's addresses. The first time a
segment runs it runs eagerly on a side stream (this step's work; nvcc
builds, library loads, plan caches, per-device memos and per-device limits
all happen here, outside any capture), then it is captured with
capture_error_mode "thread_local", since other host threads (the stage-2
CLI's EPIC prefetch, stage 3's init workers and prefetch, the shards of
`parallel.mesh.run_sharded`) launch meanwhile. Kernel wrappers count their
launches into the graph's record at capture (`kernels.recording`); each
replay adds the record to `kernels.LAUNCHES`.

Programs are cached per host thread (`program`, `running`), keyed by the
caller (`level_key` for the jet solve), at most MAX_PROGRAMS per thread
(least recently used dropped first). Work that runs on pool threads made
anew for each call (the distance transform) takes Programs that every
thread shares (`running(..., shared=True)`): one is lent to one thread at
a time, and the next borrower's stream waits for the last one's work. A
failed capture or replay raises; nothing falls back to the eager code.
`Eager` stands in for a Program on the eager path (the CPU, and the eager
switches that tests and chip_smoke.py use).

Host work inside a segment. A collective over several host threads (the
row split's exchanges and sums over ranks, parallel/strips.py) is a
`host_step`: eagerly it runs where it stands; in a capture it cuts the
segment, so the graph of the part before it ends, the step runs with no
capture underway on this thread (and without the capture lock, which the
other ranks need to capture up to the same step), and the next part is
captured into the same pool. A replay runs the parts and the steps in that
order; a step's result lands in the tensors its first run returned, which
keep their addresses. A host-side counter of a segment (`count`) runs
eagerly, and in a capture is kept with the graph and run by each replay,
as the kernels' launch counts are.

Memory: a capture cannot hand cached memory back to the device (the
caching allocator frees nothing while any capture is underway), and a
closed Program's pool stays reserved until the cache is emptied. So a
Program that is closed (dropped from a cache, `clear`, `discard`) empties
the cache after resetting its graphs, and a first capture empties it
beforehand when the device's free memory is below what the segment's
eager first run may have needed (the allocator's peak since it was last
reset, above what was allocated when the run began). Both happen under
one lock that every capture holds, so no capture is underway meanwhile;
`RELEASES` counts them. Device-wide syncs take the same lock
(`synchronize`): the device refuses one while any stream captures.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from types import SimpleNamespace

import torch

from .. import kernels

MAX_PROGRAMS = 16   # shapes kept per host thread, and shared ones in all

_local = threading.local()
_stats_lock = threading.Lock()
# captures and replays of every thread, and the seconds spent in first runs
# (warm-up and capture)
STATS = {"captures": 0, "replays": 0, "capture_s": 0.0}


# cache releases: before a first capture (device memory short), and after
# Programs were closed
RELEASES = {"before_capture": 0, "on_close": 0}
# held by every capture and every cache release
_capture_lock = threading.RLock()


def _add_stat(key: str, value) -> None:
    with _stats_lock:
        STATS[key] += value


def synchronize(device) -> None:
    """torch.cuda.synchronize(device) while no thread captures: a
    device-wide sync is refused while any stream of the device captures
    (stage 3's init workers capture the distance transform's graphs while
    other threads time their work)."""
    with _capture_lock:
        torch.cuda.synchronize(device)


def release_cached_memory(reason: str = "on_close") -> None:
    """Hand the caching allocator's unused blocks, closed Programs' pools
    included, back to the device while no thread captures."""
    with _capture_lock:
        torch.cuda.empty_cache()
    with _stats_lock:
        RELEASES[reason] += 1


def reset_stats() -> None:
    with _stats_lock:
        STATS.update(captures=0, replays=0, capture_s=0.0)
        RELEASES.update(before_capture=0, on_close=0)


def level_key(device, p, b: int, h: int, w: int, first_system: bool):
    """The cache key of one level shape: device, params (a frozen
    dataclass, so hashable), their route, the batch and image size, and
    whether the alternation top assembles and solves a first system."""
    return (torch.device(device), p, p.route(), b, h, w, bool(first_system))


@contextlib.contextmanager
def cutting(capture):
    """While open, this thread's host steps run through `capture.cut(step)`
    and its counts are appended to `capture.counts` (a capture in parts;
    the CPU tests' stand-ins record the cuts the same way)."""
    before = getattr(_local, "capture", None)
    _local.capture = capture
    try:
        yield capture
    finally:
        _local.capture = before


def host_step(step):
    """step(): host work in the middle of a segment (a collective over host
    threads). It must read and write only tensors that keep their
    addresses: slots, tensors made earlier in the segment, and the tensors
    it returns (None or a tensor or tuple of them), into which a replay
    copies its result. In a capture it cuts the segment (module
    docstring)."""
    capture = getattr(_local, "capture", None)
    return step() if capture is None else capture.cut(step)


def count(fn) -> None:
    """fn(): a host-side counter of a segment. In a capture it is kept with
    the graph instead and run by each replay."""
    capture = getattr(_local, "capture", None)
    if capture is None:
        fn()
    else:
        capture.counts.append(fn)


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


class Segments:
    """The host reads of a computation cut into segments over a state
    namespace `st`: a segment ends by marking the per-item `live` flags
    that the next read tests. Eagerly they are kept and read as
    `live.any()`; in a graph program (`graphed`, `st` its Slots) the
    segment writes `st.flag` = live.any() and the host reads it between
    replays."""

    def __init__(self, st, graphed: bool):
        self.st, self.graphed = st, graphed
        self.marked = None

    def mark(self, live):
        if self.graphed:
            self.st.flag = live.any()
        else:
            self.marked = live

    def read(self) -> bool:
        return bool(self.st.flag) if self.graphed \
            else bool(self.marked.any())


class Eager:
    """The eager stand-in for a Program: plain namespaces, each segment
    called as it comes."""

    graphed = False

    def __init__(self):
        self.inputs = SimpleNamespace()
        self.state = SimpleNamespace()
        self.level = None

    @staticmethod
    def run(segment, fn) -> None:
        fn()


class _Capture:
    """One segment captured into a Program's pool, cut at its host steps:
    the steps a replay runs in order (each part's graph replay, the host
    steps between them), the kernel launches counted at capture, and the
    counts each replay runs."""

    def __init__(self, pool):
        self.pool = pool
        self.graphs: list = []
        self.steps: list = []
        self.launches: dict = {}
        self.counts: list = []
        self._graph = None

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        self.graphs.append(graph)
        self.steps.append(graph.replay)

    def abandon(self) -> None:
        """End a capture that fn's error left underway."""
        if self._graph is not None:
            try:
                self._graph.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated; fn's error stands

    def cut(self, step):
        self.end()
        _capture_lock.release()
        try:
            out = step()
        finally:
            _capture_lock.acquire()
        self.steps.append(step if out is None
                          else lambda: _copy_into(out, step()))
        self.begin()
        return out

    def replay(self) -> None:
        for step in self.steps:
            step()
        kernels.add_launches(self.launches)
        for fn in self.counts:
            fn()

    def reset(self) -> None:
        for graph in self.graphs:
            graph.reset()


class Program:
    """One shape's graphs: `inputs` and `state` are its Slots, `run`
    replays a segment's graph, capturing it on the segment's first run;
    every graph is captured into the Program's one memory pool. `keep`
    holds what else the graphs read by address (a strip layout), for as
    long as the Program lives."""

    graphed = True

    def __init__(self, device):
        self.device = torch.device(device)
        self.inputs = Slots()
        self.state = Slots()
        self.graphs: dict = {}
        self.level = None     # the segments' owner, set by the caller
        self.keep = None
        self.pool = torch.cuda.graph_pool_handle()
        self.released = None  # a shared Program: its last borrower's work
        self._side = torch.cuda.Stream(self.device)

    def run(self, segment, fn) -> None:
        """fn() as a graph: replayed if `segment` was captured, else run
        eagerly on the side stream and then captured."""
        entry = self.graphs.get(segment)
        if entry is not None:
            entry.replay()
            _add_stat("replays", 1)
            return
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            base = torch.cuda.memory_allocated(self.device)
            fn()
            need = torch.cuda.max_memory_allocated(self.device) - base
            with _capture_lock:
                if torch.cuda.mem_get_info(self.device)[0] < need:
                    release_cached_memory("before_capture")
                entry = _Capture(self.pool)
                with kernels.recording() as launches, cutting(entry):
                    entry.begin()
                    try:
                        fn()
                        entry.end()
                    except BaseException:
                        entry.abandon()
                        raise
                entry.launches = launches
        current.wait_stream(self._side)
        self.graphs[segment] = entry
        _add_stat("captures", 1)
        _add_stat("capture_s", time.perf_counter() - t0)

    def close(self) -> None:
        """Free the graphs and slots once the device has run them (`_close`
        then hands the memory back to the device)."""
        with _capture_lock:
            torch.cuda.synchronize(self.device)
            for entry in self.graphs.values():
                entry.reset()
            self.graphs.clear()
            self.inputs = self.state = self.level = self.keep = None


def _close(progs) -> None:
    """Close Programs and hand their memory back to the device."""
    for prog in progs:
        prog.close()
    if progs:
        release_cached_memory()


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
    dropped = []
    while len(cache) >= MAX_PROGRAMS:
        dropped.append(cache.popitem(last=False)[1])
    _close(dropped)
    prog = cache[key] = build()
    return prog


def discard(key) -> None:
    """Drop this thread's Program for `key` (after a failed run, whose
    state is unknown)."""
    prog = _cache().pop(key, None)
    if prog is not None:
        _close([prog])


def clear() -> None:
    """Drop every Program of this thread."""
    cache = _cache()
    progs = list(cache.values())
    cache.clear()
    _close(progs)


def cached_keys() -> list:
    return list(_cache())


_shared: collections.OrderedDict = collections.OrderedDict()  # key -> idle
_shared_lock = threading.Lock()


def _take_shared(key):
    with _shared_lock:
        idle = _shared.get(key)
        return idle.pop() if idle else None


def _give_back(key, prog: Program) -> None:
    """Return a borrowed Program; beyond MAX_PROGRAMS idle ones, drop the
    least recently returned."""
    with _shared_lock:
        _shared.setdefault(key, []).append(prog)
        _shared.move_to_end(key)
        dropped = []
        while sum(map(len, _shared.values())) > MAX_PROGRAMS:
            oldest, idle = next(iter(_shared.items()))
            dropped.append(idle.pop(0))
            if not idle:
                del _shared[oldest]
    _close(dropped)


def clear_shared() -> None:
    """Drop every idle shared Program."""
    with _shared_lock:
        idle = [p for progs in _shared.values() for p in progs]
        _shared.clear()
    _close(idle)


def shared_keys() -> list:
    with _shared_lock:
        return [k for k, progs in _shared.items() for _ in progs]


@contextlib.contextmanager
def running(key, device, graphed: bool, shared: bool = False):
    """The Program that a caller drives for `key`: `Eager()` unless
    `graphed`; else this thread's cached Program, or with `shared` one
    lent from the cache every thread shares (made if none is idle; the
    current stream first waits for its last borrower's work). A Program
    whose run raised is dropped: its state is unknown."""
    if not graphed:
        yield Eager()
        return
    device = torch.device(device)
    if not shared:
        prog = program(key, lambda: Program(device))
        try:
            yield prog
        except BaseException:
            discard(key)
            raise
        return
    prog = _take_shared(key)
    if prog is None:
        prog = Program(device)
    elif prog.released is not None:
        torch.cuda.current_stream(device).wait_event(prog.released)
    try:
        yield prog
    except BaseException:
        _close([prog])
        raise
    prog.released = torch.cuda.Event()
    prog.released.record(torch.cuda.current_stream(device))
    _give_back(key, prog)
