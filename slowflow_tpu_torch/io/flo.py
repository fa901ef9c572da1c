"""Middlebury .flo optical-flow codec.

Format (reference: epic_flow_extended/io.c:53-96):
  float32 magic 202021.25, int32 width, int32 height, then row-major
  interleaved (u, v) float32 pairs per pixel.
"""
from __future__ import annotations

import numpy as np

FLO_MAGIC = 202021.25
# Flow values above this threshold mark unknown flow (utils/hypothesis.h:22-24).
UNKNOWN_FLOW = 1e10
UNKNOWN_FLOW_THRESH = 1e9


def read_flo(path) -> np.ndarray:
    """Read a .flo file. Returns float32 array of shape [H, W, 2] = (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic.size == 0 or abs(float(magic[0]) - FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: not a .flo file (magic={magic})")
        w, h = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, np.float32, int(w) * int(h) * 2)
    if data.size != int(w) * int(h) * 2:
        raise ValueError(f"{path}: truncated .flo file")
    return data.reshape(int(h), int(w), 2)


def write_flo(path, flow: np.ndarray) -> None:
    """Write [H, W, 2] (u, v) float32 flow to a .flo file."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        np.ascontiguousarray(flow).tofile(f)
