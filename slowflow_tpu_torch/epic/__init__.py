"""EpicFlow's sparse-to-dense initialization on PyTorch: edge maps, the
grid matcher, the geodesic distance transform with the host seed-graph
k-NN, and the NW / LA interpolation."""
from .distance import (dist_trf_nnfield, dist_trf_nnfield_batched,
                       distance_transform)
from .interp import EpicParams, epic, epic_batched
