"""Stage 3, dense tracking: trajectory accumulation, hypothesis energies,
TRW / BP selection and the per-final-pair driver."""
from .accumulate import (
    accumulate_consistent_batches, accumulate_flow, accumulate_batches,
    fuse_occlusions, forward_backward_check,
)
from .hypothesis import HypothesisSet
from .mrf import solve_multilabel
