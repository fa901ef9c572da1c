"""Binary float32 edge-map files (SED output), as the JAX package's
`slowflow_tpu.io.edges` reads and writes them: width*height float32 values,
row-major H x W."""
from __future__ import annotations

import numpy as np


def read_edges(path, width: int, height: int) -> np.ndarray:
    data = np.fromfile(path, dtype=np.float32, count=width * height)
    if data.size != width * height:
        raise ValueError(f"{path}: expected {width * height} floats, got "
                         f"{data.size}")
    return data.reshape(height, width)


def write_edges(path, edges: np.ndarray) -> None:
    np.ascontiguousarray(edges, dtype=np.float32).tofile(path)
