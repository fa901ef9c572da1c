"""File I/O of the port: Middlebury .flo flow, images and PBM masks, SED edge
maps and DeepMatching match files (numpy + PIL; the same formats as the JAX
package's slowflow_tpu.io)."""
from .edges import read_edges, write_edges
from .flo import read_flo, write_flo
from .images import read_image, read_pbm, write_image, write_pbm
from .matches import read_matches, write_matches
