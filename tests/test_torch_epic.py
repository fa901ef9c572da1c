"""The port's EPIC layer against the JAX package's, on the CPU.

Lab conversion, saliency, luminance and the edge detector within 1e-5 of
the plane max (the port's cube root is a float64 power rounded to float32;
XLA's float32 cbrt differs from it by about an ulp, which the test bounds
and measures); the grid matcher's kept matches row for row on a textured
pair with a known integer shift, and on a pair with flat regions every
differing grid point a tie (its two costs within 1e-5 relative); the
matcher's twin against JAX's compiled costs and the numpy model of its CUDA
kernel (tests/match_model.py) against the twin, both directions, with a
radius beyond half the image, points on the border, flat regions, exact
ties and a batch split into chunks (labels equal except at ties); the
distance transform's distances within 1e-5 relative and its labels
identical except where the two competing seeds' distances tie within 1e-6
relative, on the geometries of tests/test_epic.py (uniform cost, a wall,
random cost); the seed graph and its k-NN identical (the port's C++ copy,
its Python Dijkstra and the JAX package's knn_graph_all); the NW / LA fits
within 1e-5; the fit kernel's packed table (`pack_jobs`) against a loop
over the jobs; `epic_batched` end to end (LA and NW, prefilter on) with a
median |dflow| <= 1e-4 px and >= 99.9 % of pixels within 1e-3 px; the
parameter presets field by field. Inputs come from seeded numpy generators.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slowflow_tpu import native as jnative
from slowflow_tpu.core import image as jimage
from slowflow_tpu.epic import distance as jdist
from slowflow_tpu.epic import edges as jedges
from slowflow_tpu.epic import interp as jinterp
from slowflow_tpu.epic import matching as jmatch
from slowflow_tpu_torch import native
from slowflow_tpu_torch.core import image
from slowflow_tpu_torch.epic import distance, edges, interp, matching

import match_model

CPU = torch.device("cpu")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _smooth(rng, shape, k=3):
    from scipy.ndimage import uniform_filter

    x = rng.random(shape) * 255
    return np.stack([uniform_filter(c, k) for c in x]).astype(np.float32)


# ------------------------------------------------------------ image maps
@pytest.mark.parametrize("shape", [(3, 23, 31), (2, 3, 29, 18)],
                         ids=["one", "batch"])
def test_lab_saliency_luminance_edges(shape):
    im = (np.random.default_rng(0).random(shape) * 255).astype(np.float32)
    t = torch.tensor(im)
    flat = im.reshape(-1, 3, *shape[-2:])
    for name, mine, theirs in (
            ("lab", image.rgb_to_lab(t), jimage.rgb_to_lab),
            ("luminance", image.luminance(t), jimage.luminance),
            ("saliency", image.saliency(image.rgb_to_lab(t), 0.8, 1.0),
             lambda x: jimage.saliency(jimage.rgb_to_lab(x), 0.8, 1.0)),
            ("edges", edges.detect_edges(t), jedges.detect_edges)):
        want = np.stack([np.asarray(theirs(jnp.asarray(f))) for f in flat])
        got = mine.numpy().reshape(want.shape)
        assert _rel(got, want) <= 1e-5, name


def test_cube_root_difference_is_bounded():
    """The port's cube root against XLA's float32 cbrt over [0, 1.2]: the
    largest difference is a few float32 ulp of the result."""
    x = np.linspace(0.0, 1.2, 200001, dtype=np.float32)
    mine = image._cbrt(torch.tensor(x)).numpy()
    theirs = np.asarray(jnp.cbrt(jnp.asarray(x)))
    exact = np.cbrt(x.astype(np.float64))
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(mine - exact) / ulp) <= 0.5 + 1e-6
    assert np.max(np.abs(mine - theirs) / ulp) <= 4.0


# --------------------------------------------------------------- matcher
def _patch_cost(g1, g2, y, x, dy, dx, r=4):
    """The matcher's cost of one displacement at one point, in float64."""
    h, w = g1.shape
    c = 0.0
    for yy in range(y - r, y + r + 1):
        for xx in range(x - r, x + r + 1):
            if not (0 <= yy < h and 0 <= xx < w):
                continue
            y2, x2 = yy + dy, xx + dx
            inside = 0 <= y2 < h and 0 <= x2 < w
            c += abs(g1[yy, xx] - (g2[y2, x2] if inside else 0.0)) \
                + (0.0 if inside else 1e3)
    return c


def test_grid_matches_shifted_texture():
    base = _smooth(np.random.default_rng(1), (3, 60, 80))
    im1 = base[:, 5:45, 5:69]
    im2 = base[:, 3:43, 8:72]         # im1[y, x] = im2[y + 2, x - 3]
    want = jmatch.grid_matches(im1, im2, radius=6)
    got = matching.grid_matches(im1, im2, radius=6, device=CPU)
    assert len(want) > 20
    np.testing.assert_array_equal(got, want)
    inner = (want[:, 0] >= 10) & (want[:, 1] >= 10) & (want[:, 0] <= 54) \
        & (want[:, 1] <= 30)
    np.testing.assert_array_equal(want[inner, 2] - want[inner, 0], -3)
    np.testing.assert_array_equal(want[inner, 3] - want[inner, 1], 2)


def test_grid_matches_flat_regions_differ_only_on_ties():
    """Flat patches make many displacements cost the same: wherever the
    two matchers' forward displacements differ, the costs of both agree
    within 1e-5 relative."""
    rng = np.random.default_rng(2)
    base = _smooth(rng, (3, 56, 72))
    base[:, 10:34, 8:40] = 90.0
    base[:, 30:50, 40:70] = 200.0
    im1 = base[:, 4:44, 4:64].copy()
    im2 = base[:, 5:45, 2:62].copy()
    ys_np, xs_np = np.mgrid[4:40:8, 4:60:8]
    ys, xs = ys_np.ravel(), xs_np.ravel()
    radius = 5
    jdx, jdy, _ = (np.asarray(a) for a in jmatch._grid_match_core(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(ys), jnp.asarray(xs),
        radius, 4))
    tdx, tdy, _ = (a.numpy() for a in matching.grid_match_core(
        torch.tensor(im1)[None], torch.tensor(im2)[None],
        torch.as_tensor(ys), torch.as_tensor(xs), radius, 4))
    g1 = np.asarray(jimage.luminance(jnp.asarray(im1)), np.float64)
    g2 = np.asarray(jimage.luminance(jnp.asarray(im2)), np.float64)
    differ = np.nonzero((jdx != tdx[0]) | (jdy != tdy[0]))[0]
    for i in differ:
        cj = _patch_cost(g1, g2, ys[i], xs[i], jdy[i], jdx[i])
        ct = _patch_cost(g1, g2, ys[i], xs[i], tdy[0, i], tdx[0, i])
        assert abs(cj - ct) <= 1e-5 * max(cj, ct, 1e-30), (i, cj, ct)
    # the same tie rule makes them agree on most points
    assert len(differ) <= len(ys) // 4


def test_grid_matches_batched_equals_per_pair():
    rng = np.random.default_rng(3)
    a = _smooth(rng, (3, 3, 33, 41))
    b = np.roll(a, (1, -2), axis=(2, 3))
    both = matching.grid_matches_batched(a, b, radius=4, device=CPU)
    want = jmatch.grid_matches_batched(a, b, radius=4)
    for i in range(3):
        np.testing.assert_array_equal(
            both[i], matching.grid_matches(a[i], b[i], radius=4, device=CPU))
        np.testing.assert_array_equal(both[i], want[i])


def _match_case(name):
    """(g1, g2 [B, H, W] float32 luminance, ys, xs [B, P], radius, chunk):
    a radius beyond half the image, points on every border row and column,
    flat regions with many ties, exact ties on constant planes, and a batch
    that the twin splits into chunks of one pair."""
    rng = np.random.default_rng(11)
    if name == "constant":
        g = np.full((2, 18, 22), 0.5, np.float32)
        ys, xs = np.mgrid[0:18:5, 0:22:7]
        return g, g.copy(), ys.ravel(), xs.ravel(), 6, None
    shape = (2, 3, 30, 36) if name != "chunked" else (3, 3, 26, 31)
    base = _smooth(rng, shape)
    if name == "flat":
        base[..., 4:20, 3:22] = 90.0
        base[..., 15:28, 20:34] = 200.0
    im2 = np.roll(base, (1, -2), axis=(2, 3))
    g1, g2 = (image.luminance(torch.tensor(a)).numpy() for a in (base, im2))
    h, w = g1.shape[1:]
    if name == "border":
        ys = np.array([0, 0, 0, h - 1, h - 1, h - 1, 13, 13, 1, h - 2])
        xs = np.array([0, w // 2, w - 1, 0, w // 2, w - 1, 0, w - 1, 1,
                       w - 2])
        return g1, g2, ys, xs, 5, None
    ys, xs = np.mgrid[2:h:6, 3:w:7]
    radius = {"wide_radius": 16, "flat": 5, "chunked": 4}[name]
    return g1, g2, ys.ravel(), xs.ravel(), radius, \
        1 if name == "chunked" else None


def _jax_labels(g1, g2, ys, xs, radius, patch_r=4):
    """k [B, P] of the JAX package's compiled costs, first index on ties."""
    return np.stack([np.asarray(jnp.argmin(jmatch._match_costs(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ys), jnp.asarray(xs),
        radius, patch_r).reshape(len(ys), -1), axis=1))
        for a, b in zip(g1, g2)])


def _port_labels(g1, g2, ys, xs, radius, chunk, patch_r=4):
    b = g1.shape[0]
    pts = [torch.as_tensor(np.broadcast_to(a, (b, len(a))).copy())
           for a in (ys, xs)]
    with mock.patch.object(matching, "_CHUNK_ELEMENTS", chunk
                           or matching._CHUNK_ELEMENTS), \
            mock.patch.object(matching, "_best_displacement",
                              wraps=matching._best_displacement) as twin:
        dx, dy = matching._match_points(torch.tensor(g1), torch.tensor(g2),
                                        *pts, radius, patch_r)
    calls = twin.call_count
    d = 2 * radius + 1
    return ((dy + radius) * d + dx + radius).numpy(), calls


@pytest.mark.parametrize("case", ["wide_radius", "border", "flat",
                                  "constant", "chunked"])
def test_matcher_twin_and_kernel_model_match_jax(case):
    """The twin against JAX's `_match_costs` argmin, and the numpy model of
    the CUDA kernel's arithmetic (tests/match_model.py) against the twin,
    both directions, on the same float32 planes: labels equal wherever the
    two displacements' float64 costs differ by more than 1e-5 relative,
    and equal everywhere where the costs are exact (constant planes)."""
    g1, g2, ys, xs, radius, chunk = _match_case(case)
    b = g1.shape[0]
    pts = np.broadcast_to(ys, (b, len(ys))), np.broadcast_to(xs, (b, len(xs)))
    for a, c in ((g1, g2), (g2, g1)):
        want = _jax_labels(a, c, ys, xs, radius)
        got, calls = _port_labels(a, c, ys, xs, radius, chunk)
        model = match_model.best_displacement(a, c, *pts, radius, 4)
        assert calls == (b if chunk else 1)
        for other in (want, model):
            ties = match_model.differ_only_on_ties(a, c, *pts, got, other,
                                                   radius, 4)
            assert all(ok for _, ok in ties), ties
            assert len(ties) <= got.size // 4
        if case == "constant":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(model, want)
        elif case != "flat":
            np.testing.assert_array_equal(got, want)


def test_kernel_model_ties_take_the_first_index():
    """Two displacements of exactly equal least cost: the model (as the
    kernel's (cost, k) reduction) and the twin keep the first in k order."""
    g = np.zeros((1, 12, 12), np.float32)
    g2 = g.copy()
    g[0, 5, 5] = g2[0, 4, 5] = g2[0, 6, 5] = 1.0      # dy = -1 and dy = +1
    ys, xs = np.array([[5]]), np.array([[5]])
    radius = 2
    d = 2 * radius + 1
    k_model = match_model.best_displacement(g, g2, ys, xs, radius, 0)
    got, _ = _port_labels(g, g2, ys[0], xs[0], radius, None, patch_r=0)
    assert k_model[0, 0] == got[0, 0] == (-1 + radius) * d + radius


# ---------------------------------------------------- distance transform
def _seeded(cost, seeds):
    h, w = cost.shape
    sd = np.full((h, w), jdist.BIG, np.float32)
    sl = np.full((h, w), -1, np.int32)
    for i, (x, y) in enumerate(seeds):
        sd[y, x] = cost[y, x]
        sl[y, x] = i
    return sd, sl


def _jax_dt(cost, seeds):
    sd, sl = _seeded(cost, seeds)
    d, lab = jdist.distance_transform(jnp.asarray(cost), jnp.asarray(sd),
                                      jnp.asarray(sl), max_iter=256)
    return np.asarray(d), np.asarray(lab)


def _geometry(name):
    rng = np.random.default_rng(4)
    if name == "uniform":
        return (np.full((24, 30), 1.0, np.float32),
                np.array([[5, 6], [22, 18]], np.int32))
    if name == "wall":
        cost = np.full((20, 20), 0.1, np.float32)
        cost[:, 10] = 100.0
        return cost, np.array([[2, 10], [17, 10]], np.int32)
    cost = (0.05 + rng.random((33, 41))).astype(np.float32)
    seeds = np.stack([rng.integers(0, 41, 30), rng.integers(0, 33, 30)], 1)
    return cost, np.unique(seeds, axis=0).astype(np.int32)


@pytest.mark.parametrize("geometry", ["uniform", "wall", "random"])
def test_distance_transform_matches_jax(geometry):
    cost, seeds = _geometry(geometry)
    jd, jl = _jax_dt(cost, seeds)
    sd, sl = _seeded(cost, seeds)
    td, tl = distance.distance_transform(torch.tensor(cost)[None],
                                         torch.tensor(sd)[None],
                                         torch.tensor(sl)[None])
    td, tl = td[0].numpy(), tl[0].numpy()
    assert np.all(np.abs(td - jd) <= 1e-5 * np.abs(jd))
    for y, x in zip(*np.nonzero(tl != jl)):
        # a tie: each seed's own distance to the pixel, the other seeds
        # left out, agrees within 1e-6 relative
        da = _jax_dt(cost, seeds[[jl[y, x]]])[0][y, x]
        db = _jax_dt(cost, seeds[[tl[y, x]]])[0][y, x]
        assert abs(da - db) <= 1e-6 * max(da, db), (y, x, da, db)
    if geometry == "wall":
        assert (tl[:, :10] == 0).all() and (tl[:, 11:] == 1).all()


def test_dist_trf_nnfield_batched_matches_jax():
    rng = np.random.default_rng(5)
    h, w = 29, 37
    costs, seeds, nns = [], [], []
    for b in range(3):
        costs.append((0.02 + 0.5 * rng.random((h, w))).astype(np.float32))
        n = 20 + 5 * b
        seeds.append(np.stack([rng.integers(0, w, n),
                               rng.integers(0, h, n)], 1).astype(np.int32))
        nns.append(min(8 + b, n))
    want = jdist.dist_trf_nnfield_batched(seeds, costs, nns)
    got = distance.dist_trf_nnfield_batched(seeds, costs, nns, device=CPU)
    for (jb, jdis, jl, jd), (tb, tdis, tl, td) in zip(want, got):
        np.testing.assert_array_equal(tl, jl)
        assert np.all(np.abs(td - jd) <= 1e-5 * np.abs(jd))
        np.testing.assert_array_equal(tb, jb)
        fin = np.isfinite(jdis)
        np.testing.assert_array_equal(np.isfinite(tdis), fin)
        assert np.all(np.abs(tdis[fin] - jdis[fin])
                      <= 1e-5 * np.abs(jdis[fin]))


# ----------------------------------------------------- seed graph, k-NN
def _random_csr(rng, ns, p):
    dense = rng.random((ns, ns)).astype(np.float32)
    dense = 0.5 * (dense + dense.T)
    mask = rng.random((ns, ns)) < p
    mask = mask | mask.T
    np.fill_diagonal(mask, False)
    rows, cols = np.nonzero(mask)
    indptr = np.zeros(ns + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return (np.cumsum(indptr).astype(np.int32), cols.astype(np.int32),
            dense[rows, cols])


@pytest.mark.parametrize("ns, p, k", [(12, 0.4, 5), (60, 0.08, 16),
                                      (7, 0.0, 3)],
                         ids=["dense", "sparse", "no-edges"])
def test_knn_cpp_python_and_jax_agree(ns, p, k):
    indptr, indices, data = _random_csr(np.random.default_rng(ns), ns, p)
    b_cpp, d_cpp = native.knn_graph_all(indptr, indices, data, k)
    b_py, d_py = native.knn_python(indptr, indices, data, k)
    b_jax, d_jax = jnative.knn_graph_all(indptr, indices, data, k)
    for b, d in ((b_py, d_py), (b_jax, d_jax)):
        np.testing.assert_array_equal(b_cpp, b)
        np.testing.assert_array_equal(d_cpp, d)


def test_seed_graph_matches_jax():
    cost, seeds = _geometry("random")
    d, lab = _jax_dt(cost, seeds)
    for mine, theirs in zip(distance.seed_graph(lab, d, len(seeds)),
                            jdist.seed_graph(lab, d, len(seeds))):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == theirs.dtype
    indptr, indices, data = distance.seed_graph(lab, d, len(seeds))
    np.testing.assert_array_equal(
        native.knn_graph_all(indptr, indices, data, 10)[0],
        jnative.knn_graph_all(indptr, indices, data, 10)[0])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails or is missing raises, and so does
    the k-NN search that needs the library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not build"):
        native.build()
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()
    indptr, indices, data = _random_csr(np.random.default_rng(0), 5, 0.5)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.knn_graph_all(indptr, indices, data, 3)


# --------------------------------------------------------- interpolation
def _knn_problem(seed=6, ns=40, k=12):
    rng = np.random.default_rng(seed)
    nnf = np.stack([np.concatenate([[i], rng.choice(ns, k - 1,
                                                    replace=False)])
                    for i in range(ns)]).astype(np.int32)
    nnf[rng.random((ns, k)) < 0.1] = -1
    nnf[:, 0] = np.arange(ns)
    dis = np.where(nnf >= 0, rng.random((ns, k)) * 3, np.inf)
    seeds = (rng.random((ns, 2)) * 50).astype(np.float32)
    vects = rng.normal(0, 2, (ns, 2)).astype(np.float32)
    return nnf, dis, seeds, vects


def test_fits_match_jax():
    nnf, dis, seeds, vects = _knn_problem()
    disk = interp._kernelize(dis, 1.1)
    np.testing.assert_array_equal(disk, jinterp._kernelize(dis, 1.1))
    assert np.all(disk[~np.isfinite(dis)] == 0.0)
    assert _rel(interp.fit_nadarayawatson(nnf, disk, vects),
                jinterp.fit_nadarayawatson(nnf, disk, vects)) <= 1e-5
    assert _rel(interp.fit_localaffine(nnf, disk, seeds, vects),
                jinterp.fit_localaffine(nnf, disk, seeds, vects)) <= 1e-5


@pytest.mark.parametrize("jobs", [((40, 12), (1, 1), (25, 7)), ((30, 9),)],
                         ids=["ragged", "one_job"])
def test_pack_jobs_matches_a_per_job_loop(jobs):
    """The fit kernel's packed table against a loop over the jobs: table
    rows job after job, columns padded with -1 / +inf, each seed's job, its
    table row and distance at its pixel, and the jobs' first rows, so that
    starts[job] + a job-local index is the row the loop gives; and the
    twin's fits of the packed table, gathered per seed (global indices),
    equal the per-job fits of `dist_trf_nnfield_batched`'s gather."""
    rng = np.random.default_rng(len(jobs))
    probs = []
    for b, (ns, k) in enumerate(jobs):
        nnf, dis, seeds, vects = _knn_problem(seed=b, ns=ns, k=k)
        rows = np.arange(ns)
        rows[rng.random(ns) < 0.2] = rng.integers(0, ns)  # shared pixels
        d0 = rng.random(ns).astype(np.float32)
        probs.append((nnf, dis.astype(np.float32), rows, d0, seeds, vects))
    packed = interp.pack_jobs(*([p[i] for p in probs] for i in range(6)),
                              CPU)
    assert [a.dtype for a in packed] == [torch.float32] * 2 + [
        torch.int32, torch.float32, torch.int32, torch.float32, torch.int32,
        torch.int32]
    seeds, vects, nnf, dis, src, d0, job, starts = (a.numpy()
                                                    for a in packed)
    kmax = max(k for _, k in jobs)
    assert nnf.shape == dis.shape == (sum(ns for ns, _ in jobs), kmax)
    assert len(starts) == len(jobs) + 1 and starts[-1] == len(nnf)
    base = starts[job]
    row = 0
    for b, (p_nnf, p_dis, p_rows, p_d0, p_seeds, p_vects) in enumerate(probs):
        ns, k = p_nnf.shape
        assert starts[b] == row and (job[row:row + ns] == b).all()
        for i in range(ns):
            s = row + i
            assert base[s] == row and d0[s] == p_d0[i]
            assert src[s] == p_rows[i]
            np.testing.assert_array_equal(nnf[s, :k], p_nnf[i])
            np.testing.assert_array_equal(dis[s, :k], p_dis[i])
            assert (nnf[s, k:] == -1).all() and np.isinf(dis[s, k:]).all()
            valid = p_nnf[i] >= 0
            np.testing.assert_array_equal(
                (base[s] + nnf[s, :k])[valid], row + p_nnf[i][valid])
        np.testing.assert_array_equal(seeds[row:row + ns], p_seeds)
        np.testing.assert_array_equal(vects[row:row + ns], p_vects)
        row += ns
    own = base + src
    glob = np.where(nnf[own] >= 0, base[:, None] + nnf[own], -1)
    packed = interp.fit_localaffine(
        glob, interp._kernelize(d0[:, None] + dis[own], 1.1), seeds, vects)
    per_job = np.concatenate([interp.fit_localaffine(
        p[0][p[2]], interp._kernelize(p[3][:, None] + p[1][p[2]], 1.1),
        p[4], p[5]) for p in probs])
    assert _rel(packed, per_job) <= 1e-5


def _epic_jobs(n_jobs=2, h=36, w=44):
    """Textured Lab images, grid matches of a smooth flow with noise and a
    few gross outliers, a noisy edge map."""
    rng = np.random.default_rng(7)
    jobs = []
    for b in range(n_jobs):
        rgb = _smooth(rng, (3, h, w), k=5)
        rgb[:, :10] = 128.0           # flat: no saliency, matches dropped
        lab = np.asarray(jimage.rgb_to_lab(jnp.asarray(rgb)))
        ys, xs = np.mgrid[2:h - 2:4, 2:w - 2:4]
        pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
        flow = np.stack([1.5 + 0.02 * pts[:, 0] + 0.3 * b,
                         -0.8 + 0.01 * pts[:, 1]], 1)
        tgt = pts + flow + rng.normal(0, 0.2, pts.shape)
        m = np.concatenate([pts, tgt], 1).astype(np.float32)
        m[:3, 2] += 15.0
        e = (0.3 * rng.random((h, w))).astype(np.float32)
        jobs.append((lab, m, e))
    return jobs


@pytest.mark.parametrize("method", ["LA", "NW"])
def test_epic_batched_matches_jax(method):
    jobs = _epic_jobs()
    kw = dict(method=method, saliency_th=0.02, pref_nn=10, nn=30)
    want = jinterp.epic_batched([(l, m, e, None) for l, m, e in jobs],
                                jinterp.EpicParams(**kw))
    got = interp.epic_batched([(l, m, e, None) for l, m, e in jobs],
                              interp.EpicParams(**kw), device=CPU)
    for g, t in zip(got, want):
        d = np.abs(g - t)
        assert np.median(d) <= 1e-4
        assert (d <= 1e-3).mean() >= 0.999
    # the saliency filter and the prefilter both removed matches
    lab, m, e = jobs[0]
    sal = np.asarray(jimage.saliency(jnp.asarray(lab), 0.8, 1.0))
    assert (sal[m[:, 1].astype(int), m[:, 0].astype(int)] < 0.02).any()


def test_epic_single_with_sintel_preset_matches_jax():
    lab, m, e = _epic_jobs(1)[0]
    want = jinterp.epic(lab, m, e, jinterp.EpicParams.sintel())
    got = interp.epic(torch.tensor(lab), m, e, interp.EpicParams.sintel(),
                      device=CPU)
    d = np.abs(got - want)
    assert np.median(d) <= 1e-4 and (d <= 1e-3).mean() >= 0.999


def test_epic_params_presets_match_jax():
    for mine, theirs in ((interp.EpicParams(), jinterp.EpicParams()),
                         (interp.EpicParams.sintel(),
                          jinterp.EpicParams.sintel())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
