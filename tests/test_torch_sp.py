"""The sp row split of one level (`sharded_jet_step(mesh, p,
spatial_shard=True)`, parallel/strips.py) on the CPU, where a mesh of CPU
entries runs every strip window through the kernels' plain twins.

The plan sizes each window's ghost rows to the error cone of one pass between
two exchanges plus the warp's reach, so own rows come out exactly as on the
whole image: every route, mesh and case below is held to the port's
unsharded `compute_one_level` bitwise, and a plan one row short of the cone
must differ (the guard that the cone was counted right). The JAX package's
own sp path (`slowflow_tpu.parallel.mesh.sharded_jet_step` on the virtual
8-device CPU mesh of conftest.py) is held at its own test's atol 1e-4 with
identical labels. The strip twins of K2 / K4 / K1 / K5 and the strip ICM
are held to the whole-image functions on the rows the plan relies on.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.bench_scene import moving_sequence
from slowflow_tpu_torch.core.rows import StripRows
from slowflow_tpu_torch.core.solver import sor_coupled_rb
from slowflow_tpu_torch.core.warp_pallas import warp_stack_pallas_ref
from slowflow_tpu_torch.core.warp_shift import warp_stack_ref
from slowflow_tpu_torch.parallel import mesh as pmesh
from slowflow_tpu_torch.parallel import strips as pstrips
from slowflow_tpu_torch.variational import fused_solve, fused_warp
from slowflow_tpu_torch.variational.multiframe import compute_one_level
from slowflow_tpu_torch.variational.params import MultiFrameParams
from slowflow_tpu_torch.variational.terms import solve_binary_potts

P = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), niter_alter=3,
                     niter_outer=2, niter_solver=3, niter_graphc=3,
                     occlusion_reasoning=True, smoothing=1)
# the port's routes: merged (K2 + K1), stack (K4 + K3), unfused (K4 and
# torch-op assembly, the JAX sp path's pinned route), composed (K2 + K5),
# pallas_warp (K6's entry + K5)
ROUTES = {"merged": {}, "stack": dict(merge_warp=False),
          "unfused": dict(fused_data=False, warp_mode="banded"),
          "composed": dict(fused_solve=False),
          "pallas_warp": dict(pallas_warp=True, fused_solve=False)}
# (n_jet, n_sp, H): H not a multiple of n_sp, strips starting on odd rows
MESHES = [(1, 2, 71), (2, 2, 70), (1, 3, 71)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(b, h, w, v=-0.5, wy0=0.0, seed=0):
    """b normalized windows of the bench scene (S = 3) moving (1 + 0.2 j, v)
    px/frame, a small random initial flow around (0, wy0)."""
    rng = np.random.default_rng(seed)
    seq = np.stack([moving_sequence(5, h, w, 1.0 + 0.2 * j, v, seed=j)
                    for j in range(b)]).astype(np.float32)
    seq = (seq - seq.mean()) / seq.std()
    wx = (rng.normal(size=(b, h, w)) * 0.1).astype(np.float32)
    wy = (rng.normal(size=(b, h, w)) * 0.1 + wy0).astype(np.float32)
    cw = np.ones((b, 3, h, w), np.float32)
    return [torch.as_tensor(a) for a in (
        wx, wy, seq, cw, np.zeros((b, 3), np.float32),
        np.ones((b, 3), np.float32))]


def _mesh(n_jet, n_sp, devices=None):
    return pmesh.make_mesh(n_jet, n_sp, devices or ["cpu"] * (n_jet * n_sp))


def _equal(got, want):
    for g, w, name in zip(got, want, ("wx", "wy", "occ")):
        assert g.shape == w.shape, name
        assert torch.equal(g, w), (name, (g - w).abs().max().item())


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "{}x{}_h{}".format(*m))
def test_sp_matches_one_level_bitwise(route, shape):
    n_jet, n_sp, h = shape
    p = dataclasses.replace(P, **ROUTES[route])
    args = _scene(2, h, 20)
    want = compute_one_level(*args, p=p)
    got, plan = pstrips.run_strips(_mesh(n_jet, n_sp), p, *args)
    _equal(got, want)
    geo = plan.geometry
    assert geo.win_h < h and len(set(geo.starts)) == n_sp    # real windows
    assert any(s % 2 for s in geo.bounds[1:-1])              # odd starts
    assert plan.exchanges > 0


@pytest.mark.parametrize("route", ["merged", "composed"])
def test_sp_niter_inner(route):
    p = dataclasses.replace(P, niter_inner=2, **ROUTES[route])
    args = _scene(2, 64, 16)
    _equal(pstrips.run_strips(_mesh(1, 2), p, *args)[0],
           compute_one_level(*args, p=p))


@pytest.mark.parametrize("route", ["merged", "unfused"])
def test_sp_flow_of_several_pixels_in_y(route):
    """The scene moves 3 px a frame in y. The flow starts at 1 px (it grows
    to ~1.8 px, and the windows widen on the way) or at 2.5 px (the
    windows sized from the start flow hold it: the warps reach 6 rows
    across a strip boundary)."""
    p = dataclasses.replace(P, niter_alter=3, niter_outer=3,
                            **ROUTES[route])
    for wy0, widens in ((-1.0, True), (-2.5, False)):
        args = _scene(1, 96, 16, v=-3.0, wy0=wy0)
        want = compute_one_level(*args, p=p)
        got, plan = pstrips.run_strips(_mesh(1, 3), p, *args)
        _equal(got, want)
        # the windows held warps reaching 4 rows and more beyond the cone
        assert plan.geometry.ghost - plan.cone >= 4
        assert (plan.widenings > 0) == widens, (wy0, plan.widenings)


def _noise_inputs(b, h, w, wy0, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(b, 5, 3, h, w)).astype(np.float32)
    return [torch.as_tensor(a) for a in (
        np.zeros((b, h, w), np.float32), np.full((b, h, w), wy0, np.float32),
        seq, np.ones((b, 3, h, w), np.float32), np.zeros((b, 3), np.float32),
        np.ones((b, 3), np.float32))]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("wy0", [0.0, 0.3])
def test_one_row_short_of_the_cone_differs(route, wy0):
    """The middle strip of three has exactly `ghost` rows on each side. On
    white-noise frames one solve pass already reads the cone's last row
    (and, at wy = 0.3, the warp's one row beyond it): the plan's ghost
    rows give the whole-image result, one row fewer does not."""
    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0),
                         niter_alter=1, niter_outer=1, niter_solver=3,
                         occlusion_reasoning=False, smoothing=1,
                         **ROUTES[route])
    args = _noise_inputs(2, 96, 16, wy0)
    want = compute_one_level(*args, p=p)
    cone = pstrips.cone_rows(p)
    exact, plan = pstrips.run_strips(_mesh(1, 3), p, *args)
    _equal(exact, want)
    assert plan.geometry.ghost == cone + (1 if wy0 else 0)
    with mock.patch.object(pstrips, "cone_rows", lambda p: cone - 1):
        short, plan = pstrips.run_strips(_mesh(1, 3), p, *args)
    assert plan.geometry.ghost == cone - 1 + (1 if wy0 else 0)
    middle = slice(32, 64)
    assert not torch.equal(short[0][:, middle], want[0][:, middle])


def test_sp_over_several_host_threads():
    """Distinct devices get a host thread each and meet at a barrier: two
    CPU devices ("cpu" and "cpu:0") stand in for two cards, on a 1x2 and a
    2x2 mesh, with a widening on the way."""
    p = dataclasses.replace(P, niter_outer=3)
    args = _scene(2, 70, 16, v=-2.0)
    want = compute_one_level(*args, p=p)
    for n_jet, devices in ((1, ["cpu", "cpu:0"]),
                           (2, ["cpu", "cpu:0", "cpu", "cpu:0"])):
        got, plan = pstrips.run_strips(_mesh(n_jet, 2, devices), p, *args)
        assert len(plan.devices) == 2 and plan.group.n == 2
        assert plan.widenings > 0
        _equal(got, want)


def test_a_failing_host_thread_does_not_hang_the_others():
    """A rank that raises aborts the barrier: the call raises instead of
    leaving the other threads waiting."""
    import threading

    args = _scene(2, 70, 16)
    real = pstrips.Strips.exchange

    def exchange(self, *ts):
        if self.rank == 1:
            raise RuntimeError("exchange failed on rank 1")
        return real(self, *ts)

    caught = []

    def call():
        with mock.patch.object(pstrips.Strips, "exchange", exchange):
            try:
                pstrips.run_strips(_mesh(1, 2, ["cpu", "cpu:0"]), P, *args)
            except Exception as e:          # noqa: BLE001
                caught.append(e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "run_strips hung after a rank failed"
    assert caught and "rank 1" in str(caught[0])


def test_sharded_jet_step_entry_and_shard_jet_batch():
    """The entry point: spatial_shard splits rows on an sp mesh, without it
    the jets split over the mesh's first column; shard_jet_batch splits a
    spatial axis into the strips the plan owns, as the JAX signature does."""
    args = _scene(2, 40, 12)
    p = dataclasses.replace(P, niter_alter=2)
    want = compute_one_level(*args, p=p)
    mesh = _mesh(2, 2)
    _equal(pmesh.sharded_jet_step(mesh, p, spatial_shard=True)(*args), want)
    with mock.patch.object(pmesh, "run_strips") as strips:
        _equal(pmesh.sharded_jet_step(mesh, p)(*args), want)
        assert not strips.called
    seq = args[2]
    shards = pmesh.shard_jet_batch(mesh, seq, args[0], spatial_axis=-2)
    assert len(shards) == 4
    for i, (s, wx) in enumerate(shards):
        j, k = divmod(i, 2)
        rows = slice(20 * k, 20 * k + 20)
        assert torch.equal(s, seq[j:j + 1, ..., rows, :])
        assert torch.equal(wx, args[0][j:j + 1, rows])
    repl = pmesh.shard_jet_batch(mesh, seq)
    assert torch.equal(repl[0][0], repl[1][0])


def test_sp_matches_the_jax_sp_path():
    """The JAX package's sp path on its test's inputs (tests/test_mesh.py:
    S = 2, 32 x 40, 2 / 2 / 4 iterations, occlusion, the banded / unfused
    route it pins, jets over 4 devices and rows over 2) against the port's
    sp on a 4 x 2 mesh of CPU entries. At 32 rows the plan's ghost rows (10
    ICM sweeps) make each window the whole image, so this holds the
    function; the tests above hold the exchange."""
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from slowflow_tpu.parallel.mesh import make_mesh, sharded_jet_step
    from slowflow_tpu.variational.multiframe import MultiFrameParams as JMP
    from slowflow_tpu_torch.variational.params import from_jax_params

    jp = JMP(S=2, rho=(1.0,), omega=(1.0,), layers=1, niter_alter=2,
             niter_outer=2, niter_inner=1, niter_solver=4,
             occlusion_reasoning=True, warp_mode="banded", fused_data=False)
    b, h, w = 4, 32, 40
    rng = np.random.default_rng(3)
    seq = rng.random((b, 3, 3, h, w)).astype(np.float32) * 255.0
    zero = np.zeros((b, h, w), np.float32)
    cw = np.ones((b, 3, h, w), np.float32)
    na, ns = np.zeros((b, 3), np.float32), np.ones((b, 3), np.float32)
    mesh = make_mesh(n_jet=4, n_sp=2, devices=jax.devices()[:8])
    specs = (("jet", "sp", None), ("jet", "sp", None),
             ("jet", None, None, "sp", None), ("jet", None, "sp", None),
             ("jet", None), ("jet", None))
    with mesh:
        step = sharded_jet_step(mesh, jp, spatial_shard=True)
        want = [np.asarray(o) for o in step(*(
            jax.device_put(a, NamedSharding(mesh, JP(*s)))
            for a, s in zip((zero, zero, seq, cw, na, ns), specs)))]
    p = from_jax_params(jp)
    assert p.route().assembly == "unfused"
    got = pmesh.sharded_jet_step(_mesh(4, 2), p, spatial_shard=True)(
        *(torch.as_tensor(a) for a in (zero, zero, seq, cw, na, ns)))
    for g, wnt in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


# ------------------------------------------------------------ strip twins
def _rows(starts, lo_hi, img_h):
    return StripRows(torch.tensor(
        [(s, lo, hi) for s, (lo, hi) in zip(starts, lo_hi)],
        dtype=torch.int32), img_h)


def _windows(x, starts, win_h):
    """[E, ..., win_h, W] windows of a [1, ..., H, W] image."""
    return torch.cat([x.narrow(-2, s, win_h) for s in starts])


def test_strip_warp_twins_equal_the_sliced_image():
    """K4's and K6's twins (and so K2's warp) on windows with row0 != 0,
    odd and even, and img_h above the window: on every row whose samples
    lie in the window they equal slicing the whole image's warp, the masks
    included (outside-image samples at the image's own edges)."""
    rng = np.random.default_rng(1)
    h, w, win = 41, 13, 17
    seq = torch.tensor(rng.normal(size=(1, 5, 3, h, w)), dtype=torch.float32)
    wx = torch.tensor(rng.normal(0, 2, (1, h, w)), dtype=torch.float32)
    wy = torch.tensor(rng.uniform(-1.2, 1.2, (1, h, w)), dtype=torch.float32)
    starts = [0, 7, 12, h - win]
    rows = _rows(starts, [(0, win)] * 4, h)
    whole_k4 = warp_stack_ref(seq, wx, wy, 2)
    whole_k6 = warp_stack_pallas_ref(seq, wx, wy, [-2.0, -1.0, 0.0, 1.0, 2.0])
    win_args = [_windows(t, starts, win) for t in (seq, wx, wy)]
    got_k4 = warp_stack_ref(*win_args, 2, rows)
    got_k6 = warp_stack_pallas_ref(*win_args, [-2.0, -1.0, 0.0, 1.0, 2.0],
                                   rows)
    reach = 3     # ceil(2 * 1.2)
    for e, s in enumerate(starts):
        lo = 0 if s == 0 else reach
        hi = win if s + win == h else win - reach
        for got, whole in ((got_k4, whole_k4), (got_k6, whole_k6)):
            for g, wh in zip(got, whole):
                assert torch.equal(g[e, ..., lo:hi, :],
                                   wh[0, ..., s + lo:s + hi, :]), (e, s)


def test_strip_k2_twin_equals_the_sliced_image():
    """K2's twin in every mode on windows: equal to the whole image's
    result on the rows at least EXT = 4 rows (plus the warp's reach) from a
    window edge that is not an image edge."""
    rng = np.random.default_rng(2)
    h, w, win = 40, 12, 22
    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0))
    seq = torch.tensor(rng.normal(size=(1, 5, 3, h, w)), dtype=torch.float32)
    wx, wy = (torch.tensor(rng.uniform(-0.9, 0.9, (1, h, w)),
                           dtype=torch.float32) for _ in range(2))
    occ = torch.tensor(rng.integers(-1, 2, (1, h, w)), dtype=torch.float32)
    du, dv = (torch.tensor(rng.normal(0, 0.1, (1, h, w)),
                           dtype=torch.float32) for _ in range(2))
    cw = torch.ones((1, 3, h, w))
    starts = [0, 9, h - win]
    rows = _rows(starts, [(0, win)] * 3, h)
    keep = 4 + 2       # EXT, then ceil(2 * 0.9)
    for mode, zero in (("assembly", False), ("occ", True),
                       ("occ_assembly", True)):
        whole = fused_warp.warp_assemble_ref(seq, wx, wy, occ, du, dv, cw, p,
                                             mode=mode, zero_duv=zero)
        got = fused_warp.warp_assemble_ref(
            *(_windows(t, starts, win) for t in (seq, wx, wy, occ, du, dv,
                                                 cw)), p, mode=mode,
            zero_duv=zero, rows=rows)
        for e, s in enumerate(starts):
            lo = 0 if s == 0 else keep
            hi = win if s + win == h else win - keep
            for g, wh in zip(got, whole):
                assert torch.equal(g[e, lo:hi], wh[0, s + lo:s + hi]), (mode,
                                                                         s)


def test_strip_solver_twins_follow_the_image_colours():
    """K1's and K5's twins on windows starting on odd and even image rows:
    equal to the whole image on the rows the sweeps leave exact, and K1's
    change sums count each window's own rows only."""
    rng = np.random.default_rng(3)
    h, w, win, n = 48, 10, 24, 3
    planes = [torch.tensor(a, dtype=torch.float32) for a in (
        *rng.normal(0, 1, (2, 1, h, w)), 0.5 * rng.random((1, h, w)),
        1 + rng.random((1, h, w)), 0.3 * rng.normal(0, 1, (1, h, w)),
        1 + rng.random((1, h, w)), *rng.normal(0, 1, (2, 1, h, w)),
        *rng.normal(0, 0.1, (2, 1, h, w)))]
    _, _, reg = P.penalties()
    kw = dict(alpha=4.0, reg_pen=reg, method=1, iterations=n, omega=1.9,
              with_change=True)
    starts = [0, 11, 15, h - win]
    own = [(0, 12), (4, 8), (3, 9), (12, 24)]
    rows = _rows(starts, own, h)
    whole = fused_solve.solve_step_ref(*planes, **kw)
    got = fused_solve.solve_step_ref(
        *(_windows(t, starts, win) for t in planes), **kw, rows=rows)
    cone = 2 * n + 3
    for e, s in enumerate(starts):
        lo = 0 if s == 0 else cone
        hi = win if s + win == h else win - cone
        for g, wh in zip(got[:2], whole[:2]):
            assert torch.equal(g[e, lo:hi], wh[0, s + lo:s + hi]), s
        a, b = own[e]
        for k in range(2):
            ref = (got[k][e, a:b] - _windows(planes[8 + k], starts, win)[
                e, a:b]).abs().sum()
            torch.testing.assert_close(got[2][e, k], ref, rtol=1e-6,
                                       atol=0)     # order of the adds
    wh_, wv_ = (torch.tensor(0.5 * rng.random((1, h, w)) + 0.05,
                             dtype=torch.float32) for _ in range(2))
    k5 = dict(iterations=n, omega=1.9)
    whole = sor_coupled_rb(planes[8], planes[9], *planes[3:8], wh_, wv_, **k5)
    got = sor_coupled_rb(*(_windows(t, starts, win) for t in (
        planes[8], planes[9], *planes[3:8], wh_, wv_)), **k5, rows=rows)
    cone = 2 * n
    for e, s in enumerate(starts):
        lo = 0 if s == 0 else cone
        hi = win if s + win == h else win - cone
        for g, wh in zip(got, whole):
            assert torch.equal(g[e, lo:hi], wh[0, s + lo:s + hi]), s


def test_strip_icm_equals_the_whole_image():
    """`solve_binary_potts` over strips (the image's colours, changed flags
    and energies reduced over a jet's strips) gives the whole-image labels
    on every own row, on costs whose labels move several rows."""
    rng = np.random.default_rng(4)
    b, h, w, k = 2, 75, 14, 6
    base = rng.normal(0, 0.3, (b, h, w)).cumsum(1) / 4
    e0 = torch.tensor(base + rng.normal(0, 0.05, (b, h, w)),
                      dtype=torch.float32)
    e1 = torch.tensor(-base + rng.normal(0, 0.05, (b, h, w)),
                      dtype=torch.float32)
    p = MultiFrameParams(niter_graphc=k, niter_solver=0)
    whole = solve_binary_potts(e0, e1, 0.1, k)
    plan = pstrips.StripPlan(p, b, h, 3, ["cpu"] * (3 * b))
    assert plan.cone == 2 * k + 3
    strips = pstrips.Strips(plan, 0)
    got = solve_binary_potts(plan.windows(0, e0), plan.windows(0, e1), 0.1,
                             k, strips)
    assert torch.equal(plan.assemble([got], "cpu"), whole)
