"""File I/O of the port: Middlebury .flo flow, images and PBM masks (numpy +
PIL; the same formats as the JAX package's slowflow_tpu.io)."""
from .flo import read_flo, write_flo
from .images import read_image, read_pbm, write_image, write_pbm
