"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc, one process per `.cu` file,
all started together, and linked into one shared library with a plain C
interface, loaded with ctypes. The library lands in `_build/` inside the
package (ignored by git), keyed by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused; ptxas's register
and spill report of the build is kept beside it (`ptxas.log`). Nothing here
runs at import time. A failed build or a failed launch raises.

Every launching entry point takes raw device pointers and the current CUDA
stream as `c_void_p` and returns the `cudaError_t` of its launch; the plan
and occupancy entries fill a host array and return a `cudaError_t` too.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # seq, wx, wy, occ, du, dv, cw, out, rows, img_h, B, H, W, mode,
    # zero_duv, params (host), n_params, stream
    "sf_warp_assemble": [_P] * 9 + [_I] * 6 + [_P, _I, _P],
    # uu, vv, dpsis, a11, a12, a22, b1, b2, du, dv, ndu, ndv, scratch,
    # scratch_floats, sums, rows, B, H, W, method, reg_fct, reg_eps_sq,
    # reg_trunc, reg_trunc_val, alpha, iterations, omega, stream
    "sf_solve_step": [_P] * 13 + [_L, _P, _P] + [_I] * 5 + [_F] * 4
                     + [_I, _F, _P],
    # B, H, W, out (12 int64: the plan of K1 / K5)
    "sf_solve_plan": [_I] * 3 + [_P],
    # warped, mask, du, dv, cw, out, B, H, W, mode, zero_duv,
    # params (host), n_params, stream
    "sf_fused_data": [_P] * 6 + [_I] * 5 + [_P, _I, _P],
    # src, wx, wy, out, masks, B, F, C, H, W, factors (host), identity,
    # rows, img_h, stream
    "sf_warp_stack": [_P] * 5 + [_I] * 5 + [_P, _I, _P, _I, _P],
    # mode, zero_duv, ref, out (3 int: blocks per SM, registers, spill bytes)
    "sf_warp_assemble_occupancy": [_I] * 3 + [_P],
    "sf_fused_data_occupancy": [_I] * 3 + [_P],
    # out (3 int: blocks per SM, registers, spill bytes)
    "sf_warp_stack_occupancy": [_P],
    # du, dv, a11, a12, a22, b1, b2, wh, wv, ndu, ndv, scratch,
    # scratch_floats, rows, B, H, W, iterations, omega, stream
    "sf_sor_coupled_rb": [_P] * 12 + [_L, _P] + [_I] * 4 + [_F, _P],
    # g1, g2, ys, xs, out, B, H, W, P, radius, patch_r, stream
    "sf_grid_match": [_P] * 5 + [_I] * 6 + [_P],
    # H, W, radius, patch_r, out (6 int64: the matcher's band plan)
    "sf_grid_match_plan": [_I] * 4 + [_P],
    # smem, patch_r, out (3 int: blocks per SM, registers, spill bytes)
    "sf_grid_match_occupancy": [_L, _I, _P],
    # out (2 int64: blocks on the sentinel path, on the general path)
    "sf_grid_match_paths": [_P],
    # seeds, vects, nnf, dis, src, d0, job, starts, affine, counts, S, K,
    # coef, stream
    "sf_epic_fit": [_P] * 10 + [_I] * 2 + [_F, _P],
    # labels, start, affine, out, B, H, W, stream
    "sf_epic_apply": [_P] * 4 + [_I] * 3 + [_P],
}

# launches of each kernel wrapper; read and reset by callers that must show
# a path went through the kernels. warp_stack and warp_stack_pallas are the
# K4 and K6 entries of one kernel; grid_match is the EPIC grid matcher's,
# epic_fit / epic_apply the locally-affine interpolation's.
# Shards and the EPIC prefetch launch from several host threads, so the
# counts change under a lock. While a thread captures a CUDA graph
# its wrappers count into the graph's own record instead (`recording`), and
# every replay of that graph adds the record (`add_launches`).
LAUNCHES = {"warp_assemble": 0, "solve_step": 0, "fused_data": 0,
            "warp_stack": 0, "warp_stack_pallas": 0, "sor": 0,
            "grid_match": 0, "epic_fit": 0, "epic_apply": 0}
_count_lock = threading.Lock()
_recorder = threading.local()


def count_launch(name: str) -> None:
    record = getattr(_recorder, "counts", None)
    if record is not None:
        record[name] += 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def add_launches(counts: dict) -> None:
    with _count_lock:
        for k, v in counts.items():
            LAUNCHES[k] += v


@contextlib.contextmanager
def recording():
    """Count this thread's launches into the yielded dict, not LAUNCHES."""
    counts = dict.fromkeys(LAUNCHES, 0)
    _recorder.counts = counts
    try:
        yield counts
    finally:
        _recorder.counts = None


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libslowflow_kernels.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        cu = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(cu, objs)]
        reports, failed = [], []
        for src, proc in zip(cu, procs):
            stdout, stderr = proc.communicate()
            reports.append(f"== {src.name}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n"
                              f"{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = Path(tmp) / out.name
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        (out.parent / "ptxas.log").write_text("".join(reports))
        os.replace(lib, out)
    return out


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def library_loaded() -> bool:
    return _lib is not None


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device):
    """The current stream of `device`, which must be the calling thread's
    current CUDA device: the kernels launch on the current device."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(f"launch for {device} while the current CUDA "
                           f"device is cuda:{current}; enter "
                           "torch.cuda.device(...) first")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_rows(rows, b: int, h: int, device) -> None:
    """Raise unless `rows` is None or a core/rows.py `StripRows` for b
    windows of h rows on `device`: a contiguous int32 [b, 3] table of first
    image rows and own-row ranges inside [0, h), and an image at least h
    rows tall."""
    if rows is None:
        return
    t = rows.table
    if t.device != device or t.dtype != torch.int32 \
            or tuple(t.shape) != (b, 3) or not t.is_contiguous():
        raise ValueError(f"rows: expected a contiguous int32 [{b}, 3] table "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if rows.img_h < h:
        raise ValueError(f"rows: image of {rows.img_h} rows < window {h}")


def rows_ptr(rows):
    """The device pointer of a `StripRows` table, or None."""
    return None if rows is None else ptr(rows.table)


def require_cuda(name: str, t: torch.Tensor, shape, device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise unless `t` is a contiguous `dtype` (float32 by default) CUDA
    tensor of `shape` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
