"""Solver parameters of the multi-frame jet solve (port of
`slowflow_tpu.variational.multiframe.MultiFrameParams`).

The route fields pick which kernels carry one pyramid level, with the JAX
package's conditions (`Route`, `MultiFrameParams.route`):

  assembly "merged"  K2 warps the window and assembles in one kernel
           "stack"   K4 writes the warped window, K3 assembles from it
           "unfused" a window warp, then derivative stacks and assembly as
                     torch ops (the warp is K6's entry with `pallas_warp`,
                     else K4)
  solve    "fused"   K1 (smoothness + Laplacian RHS + SOR sweeps)
           "composed" smoothness and Laplacian RHS as torch ops, then K5

A key left unset (None) resolves to the card's route on every device:
merged, self-masking, fused occlusion order, fused solve. `warp_mode` and
`pallas_sor` chose between implementations of one function on the TPU
(the shift-grid or one-hot warp, the Pallas or XLA sweeps); on the card
every window warp outside K2 is K4's kernel (K6's entry with `pallas_warp`)
and every sweep loop outside K1 is K5, whatever they say. `warp_mode` still
takes part in the route choice, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.penalty import make_penalty

# cfg keys of the JAX package that pick TPU layouts or batching only;
# accepted and ignored
TPU_ROUTE_KEYS = (
    "slow_flow_packed_sor", "slow_flow_strip_r", "slow_flow_unroll_jets",
    "slow_flow_jet_vmap",
)


@dataclass(frozen=True)
class Route:
    """Kernels of one pyramid level (see the module docstring)."""

    assembly: str          # "merged" | "stack" | "unfused"
    fuse_occ: bool         # one occ_assembly call per alternation
    solve: str             # "fused" | "composed"


@dataclass(frozen=True)
class MultiFrameParams:
    """slow_flow_* parameters (defaults as in the JAX package)."""

    S: int = 2                       # frames per window side; ref = S - 1
    alpha: float = 4.0
    gamma: float = 6.0
    delta: float = 1.0
    rho: tuple = (1.0,)              # successive data-term weights, len ref
    omega: tuple = (1.0,)            # to-reference data-term weights, len ref
    dataterm_norm: bool = True
    smoothing: int = 1               # 0/1/2
    layers: int = 1
    p_scale: float = 0.9
    sigma: float = 0.0               # presmoothing of layer 0
    niter_alter: int = 10
    niter_graphc: int = 10
    niter_outer: int = 10
    thres_outer: float = 1e-5
    niter_inner: int = 1
    thres_inner: float = 1e-5
    niter_solver: int = 30
    sor_omega: float = 1.9
    occlusion_reasoning: bool = True
    occlusion_penalty: float = 0.1
    occlusion_alpha: float = 0.1
    robust_color: tuple = (1, 0.001, 0.5)   # (fct, eps, truncation)
    robust_grad: tuple | None = None        # defaults to robust_color
    robust_reg: tuple = (1, 0.001, 0.5)
    one_direction: bool = False             # slow_flow_method == "forward"
    hbit: bool = False                      # 16-bit input
    # route keys; None = auto (the card's route)
    warp_mode: str = "shift"                # "shift" | "banded"
    fused_data: bool = True
    merge_warp: bool | None = None
    pallas_warp: bool = False
    self_mask: bool | None = None
    fuse_occ: bool | None = None
    fused_solve: bool | None = None
    pallas_sor: bool | None = None          # selects nothing on the card

    @property
    def ref(self) -> int:
        return self.S - 1

    def route(self) -> Route:
        """The JAX package's branch conditions (compute_one_level) with
        every auto key on."""
        def on(flag):
            return flag is None or bool(flag)

        kernel_warp = not self.pallas_warp and self.warp_mode == "shift"
        if self.fused_data and on(self.merge_warp) and kernel_warp:
            assembly = "merged"
        elif self.fused_data and not self.pallas_warp:
            assembly = "stack"
        else:
            assembly = "unfused"
        fuse_occ = (assembly == "merged" and on(self.self_mask)
                    and on(self.fuse_occ) and self.occlusion_reasoning
                    and not self.one_direction and self.niter_inner == 1)
        return Route(assembly, fuse_occ,
                     "fused" if on(self.fused_solve) else "composed")

    def penalties(self):
        color = make_penalty(*self.robust_color)
        grad = make_penalty(*(self.robust_grad or self.robust_color))
        reg = make_penalty(*self.robust_reg)
        return color, grad, reg

    @classmethod
    def from_parameter_list(cls, params) -> "MultiFrameParams":
        """Build from a ParameterList holding slow_flow_* keys. The route
        keys parse as in the JAX package; TPU_ROUTE_KEYS are ignored."""

        def tri(key):
            return params.parameter(key, type=bool) if params.exists(key) \
                else None

        S = params.parameter("slow_flow_S", type=int)
        ref = S - 1
        rho = tuple(params.parameter(f"slow_flow_rho_{a}", "1.0", float)
                    for a in range(ref))
        omega = tuple(params.parameter(f"slow_flow_omega_{a}", "1.0", float)
                      for a in range(ref))
        rg = None
        if params.exists("slow_flow_robust_grad"):
            rg = (params.parameter("slow_flow_robust_grad", type=int),
                  params.parameter("slow_flow_robust_grad_eps", "0.001", float),
                  params.parameter("slow_flow_robust_grad_truncation", "0.5",
                                   float))
        return cls(
            S=S,
            alpha=params.parameter("slow_flow_alpha", type=float),
            gamma=params.parameter("slow_flow_gamma", type=float),
            delta=params.parameter("slow_flow_delta", type=float),
            rho=rho, omega=omega,
            dataterm_norm=params.parameter("slow_flow_dataterm", "1", bool),
            smoothing=params.parameter("slow_flow_smoothing", "0", int),
            layers=params.parameter("slow_flow_layers", type=int),
            p_scale=params.parameter("slow_flow_p_scale", type=float),
            sigma=params.parameter("slow_flow_sigma", "0", float)
            if params.parameter("sigma", "0", float) > 0 else 0.0,
            niter_alter=params.parameter("slow_flow_niter_alter", "1", int),
            niter_graphc=params.parameter("slow_flow_niter_graphc", "10", int),
            niter_outer=params.parameter("slow_flow_niter_outer", type=int),
            thres_outer=params.parameter("slow_flow_thres_outer", type=float),
            niter_inner=params.parameter("slow_flow_niter_inner", type=int),
            thres_inner=params.parameter("slow_flow_thres_inner", type=float),
            niter_solver=params.parameter("slow_flow_niter_solver", type=int),
            sor_omega=params.parameter("slow_flow_sor_omega", type=float),
            occlusion_reasoning=params.parameter(
                "slow_flow_occlusion_reasoning", "0", bool),
            occlusion_penalty=params.parameter(
                "slow_flow_occlusion_penalty", "1.0", float),
            occlusion_alpha=params.parameter(
                "slow_flow_occlusion_alpha", "0.5", float),
            robust_color=(params.parameter("slow_flow_robust_color", type=int),
                          params.parameter("slow_flow_robust_color_eps",
                                           type=float),
                          params.parameter("slow_flow_robust_color_truncation",
                                           "0.5", float)),
            robust_grad=rg,
            robust_reg=(params.parameter("slow_flow_robust_reg", type=int),
                        params.parameter("slow_flow_robust_reg_eps", type=float),
                        params.parameter("slow_flow_robust_reg_truncation",
                                         "0.5", float)),
            one_direction=(params.exists("slow_flow_method")
                           and params.parameter("slow_flow_method") == "forward"),
            hbit=params.parameter("16bit", "0", bool),
            warp_mode=params.parameter("slow_flow_warp_mode", cls.warp_mode,
                                       str),
            fused_data=params.parameter("slow_flow_fused_data",
                                        "1" if cls.fused_data else "0", bool),
            merge_warp=tri("slow_flow_merge_warp"),
            # the JAX package reads no cfg key for pallas_warp either
            self_mask=tri("slow_flow_self_mask"),
            fuse_occ=tri("slow_flow_fuse_occ"),
            fused_solve=tri("slow_flow_fused_solve"),
            pallas_sor=tri("slow_flow_pallas_sor"),
        )


def from_jax_params(p) -> MultiFrameParams:
    """The port's parameters for a `slowflow_tpu` MultiFrameParams (duck
    typed, so jax is not imported here): the numeric and route fields carry
    over, the layout and batching fields (TPU_ROUTE_KEYS) are dropped."""
    from dataclasses import fields

    return MultiFrameParams(**{f.name: getattr(p, f.name)
                               for f in fields(MultiFrameParams)})
