"""Small-segment removal on integer label / consistency maps (the port's copy
of `slowflow_tpu.utils.segments`).

`removeSmallSegments` (utils/utils.cpp:169-284): flood connected components
whose members differ by at most `similarity_threshold`, zero out components
smaller than `min_segment_size`. The flood fill is a scipy connected-component
labeling on the host: the stage-3 driver calls it on one small [h, w] map per
frame rate, so it stays host numpy as in the JAX package.
Returns the validity mask (255 valid / 0 removed); modifies `F` in place like
the reference.
"""
from __future__ import annotations

import numpy as np


def remove_small_segments(F: np.ndarray, similarity_threshold: float,
                          min_segment_size: int) -> np.ndarray:
    from scipy import ndimage

    F = np.asarray(F)
    valid = np.full(F.shape, 255, np.uint8)

    # components connect 4-neighbours whose values differ <= threshold; for
    # the pipeline's {0,1} consistency maps this is exact component labeling
    # per value when threshold < 1.
    values = np.unique(F)
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    min_gap = (np.diff(np.sort(values.astype(np.float64))).min()
               if len(values) > 1 else np.inf)
    if similarity_threshold < min_gap:
        for v in values:
            region = F == v
            labels, n = ndimage.label(region, structure=structure)
            if n == 0:
                continue
            sizes = np.bincount(labels.ravel())
            small = sizes < min_segment_size
            small[0] = False
            bad = small[labels] & region
            valid[bad] = 0
            F[bad] = 0
    else:
        # general path: label regions of quantized similarity
        q = np.round(F / max(similarity_threshold, 1e-9)).astype(np.int64)
        for v in np.unique(q):
            region = q == v
            labels, n = ndimage.label(region, structure=structure)
            if n == 0:
                continue
            sizes = np.bincount(labels.ravel())
            small = sizes < min_segment_size
            small[0] = False
            bad = small[labels] & region
            valid[bad] = 0
            F[bad] = 0
    return valid
