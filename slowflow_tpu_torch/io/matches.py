"""DeepMatching-style text match files, as the JAX package's
`slowflow_tpu.io.matches` reads and writes them: each line starts with
`x1 y1 x2 y2`; further values on a line are ignored."""
from __future__ import annotations

import numpy as np


def read_matches(path) -> np.ndarray:
    """Return float32 array [N, 4] of (x1, y1, x2, y2)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                rows.append([float(v) for v in parts[:4]])
            except ValueError:
                continue
    if not rows:
        return np.zeros((0, 4), np.float32)
    return np.asarray(rows, dtype=np.float32)


def write_matches(path, matches: np.ndarray) -> None:
    matches = np.asarray(matches)
    with open(path, "w") as f:
        for row in matches:
            f.write(" ".join(f"{v:g}" for v in row[:4]) + "\n")
