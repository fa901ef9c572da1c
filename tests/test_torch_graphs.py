"""The segmented level of the port's jet solve (variational/multiframe.py
`_Level`) and its CUDA-graph bookkeeping (variational/graphs.py), on the CPU.

- The ICM with no per-sweep read (its form inside a graph) equals the
  early-exit ICM bitwise, and the JAX package's ICM label for label, on
  seeded random energies at 3 shapes and 2 values of alpha.
- The level in its graph form (state in `graphs.Slots`, whose tensors keep
  their memory and are written by copies; the ICM's fixed sweeps; the exit
  flag written by each segment and read between them) equals the eager
  level bitwise on the merged, stack and unfused routes with one and two
  inner iterations, twice over the same Slots (as a replay reuses them).
- Through the pyramid, the graph form is held to the JAX XLA route
  (`warp_mode="banded", fused_data=False`) with test_slice_matches_jax's
  bounds on the three routes.
- The cache key tells apart two params that differ in one field, and the
  batch, size, device and first-system flag; the CPU never captures.
- Launch counts during a capture go to the graph's record, not to
  LAUNCHES, for the capturing thread only; replays add the record.
- `run_sharded` runs each mesh position on the same host thread from call
  to call (the graphs are cached per thread).
- With niter_outer = 0 on the fused-occlusion route the level (eager and
  in its graph form) equals the route with the fusion off and leaves the
  flow as it came.
"""
import dataclasses
import threading
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slowflow_tpu.variational import multiframe as jmf
from slowflow_tpu_torch import kernels
from slowflow_tpu_torch.parallel import mesh
from slowflow_tpu_torch.variational import graphs, terms
from slowflow_tpu_torch.variational import multiframe as tmf
from slowflow_tpu_torch.variational.params import MultiFrameParams
from test_torch_slice import SLICE, _check_slice, _port_params, _scene
from test_torch_tracking import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("alpha", [0.1, 1.0])
@pytest.mark.parametrize("shape", [(2, 17, 23), (1, 40, 64), (3, 9, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_icm_fixed_sweeps_equal_early_exit(shape, alpha):
    rng = np.random.default_rng(31)
    e0 = (0.05 * rng.random(shape)).astype(np.float32)
    e1 = (0.05 * rng.random(shape) + 0.02).astype(np.float32)
    args = (torch.tensor(e0), torch.tensor(e1), alpha, 10)
    terms.ICM_SWEEPS.clear()
    early = terms.solve_binary_potts(*args)
    ran = next(iter(terms.ICM_SWEEPS))
    fixed = terms.solve_binary_potts(*args, early_exit=False)
    assert torch.equal(fixed, early)
    assert sum(terms.ICM_SWEEPS.values()) == 1     # the fixed run counts none
    for i in range(shape[0]):
        want = jmf.solve_binary_potts(jnp.asarray(e0[i]), jnp.asarray(e1[i]),
                                      alpha, 10)
        np.testing.assert_array_equal(fixed[i].numpy(), np.asarray(want))
    if alpha == 1.0 and shape[1] > 9:
        assert ran < 10        # the early exit was taken: the case matters


def _graph_form_level(wx, wy, seq, channel_w, norm_avg, norm_std, p,
                      strips=None, *, runs=1):
    """compute_one_level's graph program, run without capture: inputs and
    state in Slots, each segment called where a graph would be replayed."""
    assert strips is None
    ins, st = graphs.Slots(), graphs.Slots()
    ins.seq, ins.channel_w, ins.norm_avg, ins.norm_std = (
        seq, channel_w, norm_avg, norm_std)
    level = tmf._Level(ins.seq, ins.channel_w, ins.norm_avg, ins.norm_std,
                       p, st=st)
    outs = []
    for _ in range(runs):
        st.wx, st.wy = wx, wy
        level.drive(lambda segment, fn: fn())
        outs.append((st.wx.clone(), st.wy.clone(), st.occ.clone()))
    return outs if runs > 1 else outs[0]


def _level_inputs(route, niter_inner, b=2, h=36, w=40):
    jp = dataclasses.replace(SLICE, niter_alter=3, niter_outer=3,
                             niter_inner=niter_inner, layers=1)
    p = _port_params(jp, route)
    seq = torch.tensor(_scene(b, p.S, h, w, seed=3))
    rng = np.random.default_rng(5)
    wx, wy = (torch.tensor(0.5 * rng.standard_normal((b, h, w)),
                           dtype=torch.float32) for _ in range(2))
    cw = torch.tensor(0.5 + rng.random((b, 3, h, w)), dtype=torch.float32)
    na, ns = torch.zeros((b, 3)), torch.ones((b, 3))
    return (wx, wy, seq, cw, na, ns), p


@pytest.mark.parametrize("niter_inner", [1, 2])
@pytest.mark.parametrize("route", ["merged", "stack", "unfused"])
def test_graph_form_level_equals_eager(route, niter_inner):
    args, p = _level_inputs(route, niter_inner)
    want = tmf.compute_one_level(*args, p=p)
    for got in _graph_form_level(*args, p=p, runs=2):
        for g, x in zip(got, want):
            assert torch.equal(g, x)


@pytest.mark.parametrize("route", ["merged", "stack", "unfused"])
def test_graph_form_slice_matches_jax(route):
    """test_slice_matches_jax's bounds with every level in its graph
    form."""
    with mock.patch.object(tmf, "compute_one_level", _graph_form_level):
        _check_slice(route)


def _other(name, value):
    if name == "warp_mode":
        return "banded" if value == "shift" else "shift"
    if value is None:
        return False
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    return tuple(value) + (0.5,)


def test_cache_key_tells_inputs_apart():
    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0))
    key = graphs.level_key("cuda:0", p, 4, 270, 480, True)
    assert key == graphs.level_key(torch.device("cuda:0"),
                                   dataclasses.replace(p), 4, 270, 480, True)
    for f in dataclasses.fields(p):
        q = dataclasses.replace(p, **{f.name: _other(f.name,
                                                     getattr(p, f.name))})
        assert graphs.level_key("cuda:0", q, 4, 270, 480, True) != key, \
            f.name
    for other in (("cuda:1", p, 4, 270, 480, True),
                  ("cuda:0", p, 2, 270, 480, True),
                  ("cuda:0", p, 4, 243, 480, True),
                  ("cuda:0", p, 4, 270, 432, True),
                  ("cuda:0", p, 4, 270, 480, False)):
        assert graphs.level_key(*other) != key


def test_cpu_never_captures():
    graphs.clear()
    graphs.reset_stats()
    args, p = _level_inputs("merged", 1, h=20, w=24)
    tmf.compute_one_level(*args, p=p)
    seq = args[2]
    z = torch.zeros_like(args[0])
    tmf.variational_mt_batched(z, z, seq, dataclasses.replace(p, layers=2),
                               device="cpu")
    assert graphs.STATS == {"captures": 0, "replays": 0, "capture_s": 0.0}
    assert graphs.cached_keys() == []


def test_slots_keep_their_memory():
    s = graphs.Slots()
    a = torch.arange(6.0).view(2, 3)
    s.x = a
    assert s.x is not a and torch.equal(s.x, a)       # a copy, not an alias
    ptr = s.x.data_ptr()
    s.x = a * 2
    assert s.x.data_ptr() == ptr and torch.equal(s.x, a * 2)
    s.tree = ({"u": a, "v": a + 1}, a + 2)
    ptrs = [s.tree[0]["u"].data_ptr(), s.tree[1].data_ptr()]
    s.tree = ({"u": -a, "v": -a}, -a)
    assert [s.tree[0]["u"].data_ptr(), s.tree[1].data_ptr()] == ptrs
    assert torch.equal(s.tree[0]["v"], -a)


def test_launch_records_count_the_capturing_thread_only():
    kernels.reset_launch_counts()
    with kernels.recording() as record:
        kernels.count_launch("sor")
        other = threading.Thread(target=kernels.count_launch,
                                 args=("solve_step",))
        other.start()
        other.join()
    assert record["sor"] == 1 and record["solve_step"] == 0
    assert kernels.LAUNCHES["sor"] == 0 and kernels.LAUNCHES["solve_step"] == 1
    kernels.add_launches(record)
    kernels.add_launches(record)
    assert kernels.LAUNCHES["sor"] == 2
    kernels.count_launch("sor")
    assert kernels.LAUNCHES["sor"] == 3
    kernels.reset_launch_counts()


def test_run_sharded_keeps_a_thread_per_position():
    def ident(x):
        return (torch.full((x.shape[0],), threading.get_ident(),
                           dtype=torch.float64),)

    x = torch.zeros((4, 1))
    cpus = mesh.make_mesh(devices=["cpu"] * 4)
    first = mesh.run_sharded(cpus, ident, x)[0]
    again = mesh.run_sharded(cpus, ident, x)[0]
    assert torch.equal(first, again)
    assert len(set(first.tolist())) == 4


@pytest.mark.parametrize("graph_form", [False, True],
                         ids=["eager", "graph_form"])
def test_no_outer_iteration_on_the_fused_occlusion_route(graph_form):
    """niter_outer = 0 on the merged route with the occlusion step fused
    into the first system's assembly: the alternation top solves no first
    system (`first_system` is False), so the level equals the route with
    the fusion off bitwise and leaves the flow as it came. (The JAX
    package's fused route solves one system here; the C++ reference and
    its unfused route solve none.)"""
    args, p = _level_inputs("merged", 1)
    p = dataclasses.replace(p, niter_outer=0)
    assert p.route().fuse_occ and not tmf.first_system(p)
    unfused = dataclasses.replace(p, fuse_occ=False)
    assert not unfused.route().fuse_occ
    level = _graph_form_level if graph_form else tmf.compute_one_level
    got = level(*args, p=p)
    want = tmf.compute_one_level(*args, p=unfused)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0], args[0]) and torch.equal(got[1], args[1])
    assert got[2].abs().sum() > 0          # the occlusion step still ran
