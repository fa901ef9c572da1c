"""slowflow_tpu_torch — the PyTorch + CUDA port of slowflow_tpu for NVIDIA Hopper.

The JAX package `slowflow_tpu` stays the reference; this package mirrors its
module names so each counterpart is easy to find:

  core/        clamp-to-edge convolutions, penalties, resize/pyramid, the
               exact 4-corner bilinear warp, red-black coupled SOR
  variational/ the multi-frame jet solve: parameters, plain data/smoothness
               terms, the hand-written kernels' wrappers (fused_warp,
               fused_solve, fused_data) and the coarse-to-fine solve
               (multiframe); the two-frame solve (twoframe)
  epic/        EpicFlow's sparse-to-dense initialization
  tracking/    stage 3: trajectory accumulation, hypothesis energies, TRW /
               BP selection and the per-final-pair driver
  cli/         the `adaptive_fr`, `slow_flow`, `dense_tracking` and
               `epicflow` entry points
  csrc/        CUDA C++ sources of the kernels (built with nvcc at first use)

No module of the package imports jax. No kernel is built until a CUDA
tensor first reaches a kernel wrapper.
"""

__version__ = "0.1.0"
