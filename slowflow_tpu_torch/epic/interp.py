"""Edge-preserving interpolation of correspondences (EpicFlow; torch port of
`slowflow_tpu.epic.interp`).

Pipeline per problem:
  1. rectify matches into the image area
  2. add the constant `euc` to the edge cost map
  3. saliency filter (min-eigenvalue structure tensor threshold)
  4. consistency prefilter: Nadaraya-Watson estimate over pref_nn geodesic
     neighbours, drop matches deviating more than pref_th
  5. geodesic k-NN of every seed (device distance transform + host Dijkstra)
  6. fit Nadaraya-Watson or locally-weighted affine models per seed
  7. apply them to all pixels through the closest-seed label map

The distance transforms run on the device, one batched call for the
prefilter and one for the interpolation; the saliency map too when the
caller gives none. On CUDA the locally-affine method's fits and apply are
the hand-written kernels of csrc/epic_fit.cu over all of a call's jobs at
once: the jobs' k-NN fields are packed into one table on the card
(`pack_jobs`, each job's arrays copied once), fitted in one launch
(`fit_localaffine_cuda`, the kernelized weights fused in) and applied in
one launch through the label maps the transform left on the card
(`apply_localaffine_cuda`), with one copy of the flows back. Everywhere
else (the CPU, the NW method, the prefilter's NW fit) the fits are host
numpy, as in the JAX package: `_kernelize`, `fit_localaffine` and
`apply_localaffine` are the kernels' plain twins.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..core.image import saliency as saliency_fn
from ..runtime import device_of, on_device
from ..utils.phases import phase
from .distance import dist_trf_nnfield_batched, nnfield_and_labels

# seeds whose locally-affine system met an exactly zero pivot in the fit
# kernel and took the twin's least-squares fallback there
# (`fit_localaffine_cuda`); read by tests
FIT_FALLBACK_SEEDS = 0
_fallback_lock = threading.Lock()


@dataclass
class EpicParams:
    """epic_params_t defaults."""

    method: str = "LA"          # "LA" or "NW"
    saliency_th: float = 0.045
    pref_nn: int = 25
    pref_th: float = 5.0
    nn: int = 100
    coef_kernel: float = 0.8
    euc: float = 0.001
    verbose: int = 0

    @classmethod
    def sintel(cls):
        """The preset the pipeline's stages use."""
        return cls(pref_nn=25, nn=160, coef_kernel=1.1)


def fit_nadarayawatson(nnf, dis, vects):
    """Weighted-mean flow per seed. nnf [ns, k] indices (-1 = invalid), dis
    [ns, k] kernelized weights, vects [ns, 2]."""
    valid = nnf >= 0
    idx = np.where(valid, nnf, 0)
    w = np.where(valid, dis, 0.0)
    v = vects[idx]                       # [ns, k, 2]
    s = w.sum(1, keepdims=True)
    s = np.where(s == 0, 1.0, s)
    return (w[..., None] * v).sum(1) / s


def fit_localaffine(nnf, dis, seeds, vects):
    """Locally-weighted affine model per seed: the weighted least-squares
    map from the neighbour seeds' positions to their targets, with 4
    low-weight stabilizer points around the seed. Unknowns [a00, a01, tx,
    a10, a11, ty]; returns [ns, 6].

    The normal equations are accumulated as closed-form moments (sums of
    C^2 * {X^2, XY, X, Y^2, Y, 1}, the stabilizer rows added analytically)
    in float64 over float32 products."""
    ns, k = nnf.shape
    valid = nnf >= 0
    idx = np.where(valid, nnf, 0)
    coef = np.where(valid, dis, 0.0).astype(np.float32)      # [ns, k]

    sx = seeds[:, 0].astype(np.float32)
    sy = seeds[:, 1].astype(np.float32)
    px = sx[idx]                                             # [ns, k]
    py = sy[idx]
    u = vects[idx][..., 0].astype(np.float32)
    v = vects[idx][..., 1].astype(np.float32)

    # the seed's own row is reweighted
    is_self = idx == np.arange(ns)[:, None]
    coefi = np.where(is_self, 0.01 * coef, 0.0) \
        .sum(1, dtype=np.float64).astype(np.float32)         # [ns]
    coef = np.where(is_self, coef * np.float32(0.96), coef)

    def mom(p, q):
        """sum_m p*q per seed, accumulated in float64."""
        return np.einsum("nm,nm->n", p, q, dtype=np.float64)

    P = coef * coef                                          # [ns, k]
    bx = px + u                                              # row targets
    by = py + v
    Sxx = mom(P, px * px)
    Sxy = mom(P, px * py)
    Sx = mom(P, px)
    Syy = mom(P, py * py)
    Sy = mom(P, py)
    S0 = P.sum(1, dtype=np.float64)
    Bx = np.stack([mom(P, px * bx), mom(P, py * bx), mom(P, bx)], -1)
    By = np.stack([mom(P, px * by), mom(P, py * by), mom(P, by)], -1)

    # stabilizer points at (sx +- 0.1, sy) / (sx, sy +- 0.1), weight coefi,
    # targets = the seed's own vector
    sx64 = sx.astype(np.float64)
    sy64 = sy.astype(np.float64)
    Pi = coefi.astype(np.float64) ** 2
    d2 = 2 * 0.1 * 0.1
    tx = sx64 + vects[:, 0].astype(np.float64)
    ty = sy64 + vects[:, 1].astype(np.float64)
    Sxx += Pi * (4 * sx64 * sx64 + d2)
    Sxy += Pi * 4 * sx64 * sy64
    Sx += Pi * 4 * sx64
    Syy += Pi * (4 * sy64 * sy64 + d2)
    Sy += Pi * 4 * sy64
    S0 += Pi * 4
    Bx += Pi[:, None] * np.stack(
        [4 * sx64 * tx + d2, 4 * sy64 * tx, 4 * tx], -1)
    By += Pi[:, None] * np.stack(
        [4 * sx64 * ty, 4 * sy64 * ty + d2, 4 * ty], -1)

    AtA = np.empty((ns, 3, 3), np.float64)
    AtA[:, 0, 0] = Sxx; AtA[:, 0, 1] = Sxy; AtA[:, 0, 2] = Sx
    AtA[:, 1, 0] = Sxy; AtA[:, 1, 1] = Syy; AtA[:, 1, 2] = Sy
    AtA[:, 2, 0] = Sx;  AtA[:, 2, 1] = Sy;  AtA[:, 2, 2] = S0
    AtA = AtA + 1e-9 * np.eye(3)
    try:
        solx = np.linalg.solve(AtA, Bx[..., None])[..., 0]
        soly = np.linalg.solve(AtA, By[..., None])[..., 0]
    except np.linalg.LinAlgError:
        solx = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                         for a, b in zip(AtA, Bx)])
        soly = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                         for a, b in zip(AtA, By)])
    return np.concatenate([solx, soly], axis=1).astype(np.float32)


def apply_nadarayawatson(seed_vects, labels):
    """Per-pixel flow = flow of the closest seed."""
    lab = np.clip(labels, 0, None)
    out = seed_vects[lab]
    out[labels < 0] = 0.0
    return out


def apply_localaffine(affine, labels, h, w):
    """Per-pixel flow from the closest seed's affine model:
    u = a00*x + a01*y + tx - x."""
    lab = np.clip(labels, 0, None)
    m = affine[lab]                                          # [H, W, 6]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = m[..., 0] * xx + m[..., 1] * yy + m[..., 2] - xx
    v = m[..., 3] * xx + m[..., 4] * yy + m[..., 5] - yy
    u[labels < 0] = 0.0
    v[labels < 0] = 0.0
    return np.stack([u, v], axis=-1)


def _kernelize(dis, coef_kernel):
    """exp(-coef*d) + 1e-8; unfilled neighbours (+inf) weigh 0."""
    with np.errstate(over="ignore"):
        k = np.exp(-coef_kernel * np.where(np.isfinite(dis), dis, np.inf))
    return np.where(np.isfinite(dis), k + 1e-8, 0.0)


def pack_jobs(nnfs, diss, rows, d0s, seeds, vects, device):
    """The k-NN fields of a call's jobs as one table on `device` for the fit
    kernel, as `nnfield_and_labels` gives them: seed s of a job has the
    neighbours nnf[rows[s]] at distances d0[s] + dis[rows[s]], which the
    kernel gathers. The tables' rows go job after job, each job's columns
    padded to the widest with -1 / +inf (weight 0, as unfilled neighbours
    weigh); each job's arrays are copied once, straight into their rows.

    nnfs [ns_b, k_b] int32 job-local indices (-1 unfilled), diss [ns_b,
    k_b] float32, rows [ns_b] int in [0, ns_b), d0s
    [ns_b] float32, seeds / vects [ns_b, 2]. Returns tensors (seeds [S, 2],
    vects [S, 2] float32, nnf [S, K] int32, dis [S, K] float32, src [S]
    int32, d0 [S] float32, job [S] int32: each seed's job, starts [B + 1]
    int32: each job's first row, then S): seed s's neighbours are row
    starts[job[s]] + src[s], and its neighbour j is row starts[job[s]] +
    j."""
    ns = [len(s) for s in seeds]
    starts = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    total = int(starts[-1])
    if total >= 2 ** 31:
        raise ValueError(f"pack_jobs: {total} seeds exceed int32 indices")
    k = max([n.shape[1] for n in nnfs], default=0)
    nnf = torch.empty((total, k), dtype=torch.int32, device=device)
    dis = torch.empty((total, k), dtype=torch.float32, device=device)
    src = []
    for b, (n_b, d_b, r_b) in enumerate(zip(nnfs, diss, rows)):
        if n_b.shape[0] != ns[b] or d_b.shape != n_b.shape \
                or len(r_b) != ns[b]:
            raise ValueError(f"pack_jobs: job {b}: nnf {n_b.shape} / dis "
                             f"{d_b.shape} / rows {len(r_b)} for {ns[b]} "
                             "seeds")
        r_b = np.asarray(r_b, np.int64)
        if len(r_b) and (r_b.min() < 0 or r_b.max() >= ns[b]):
            raise ValueError(f"pack_jobs: job {b}: a row outside "
                             f"[0, {ns[b]})")
        src.append(r_b)
        part, kb = slice(starts[b], starts[b + 1]), n_b.shape[1]
        nnf[part, :kb] = torch.as_tensor(np.asarray(n_b, np.int32))
        dis[part, :kb] = torch.as_tensor(np.asarray(d_b, np.float32))
        nnf[part, kb:] = -1
        dis[part, kb:] = float("inf")
    seeds, vects = (torch.as_tensor(
        np.concatenate(a).astype(np.float32).reshape(total, 2), device=device)
        for a in (seeds, vects))
    src, d0 = (torch.as_tensor(np.concatenate(a).astype(dt), device=device)
               for a, dt in ((src, np.int32), (d0s, np.float32)))
    job = torch.repeat_interleave(
        torch.arange(len(ns), dtype=torch.int32, device=device),
        torch.as_tensor(ns, device=device), output_size=total)
    return (seeds, vects, nnf, dis, src, d0, job,
            torch.as_tensor(starts.astype(np.int32), device=device))


def fit_localaffine_cuda(seeds, vects, nnf, dis, src, d0, job, starts,
                         coef_kernel):
    """`_kernelize` and `fit_localaffine` of packed jobs (`pack_jobs`'
    tensors, on the calling thread's current CUDA device) through the kernel
    of csrc/epic_fit.cu, on the current stream. The seeds whose system
    meets an exactly zero pivot take the twin's least squares in the
    kernel, counted in FIT_FALLBACK_SEEDS; a neighbour index beyond its job
    raises. Returns affine [S, 6] float32 on the device."""
    global FIT_FALLBACK_SEEDS
    dev = seeds.device
    if dev.type != "cuda":
        raise ValueError(f"fit_localaffine_cuda: tensors on {dev}, "
                         "expected CUDA")
    S, K = nnf.shape
    for name, t, shape, dtype in (
            ("seeds", seeds, (S, 2), torch.float32),
            ("vects", vects, (S, 2), torch.float32),
            ("nnf", nnf, (S, K), torch.int32),
            ("dis", dis, (S, K), torch.float32),
            ("src", src, (S,), torch.int32),
            ("d0", d0, (S,), torch.float32),
            ("job", job, (S,), torch.int32),
            ("starts", starts, (len(starts),), torch.int32)):
        kernels.require_cuda(name, t, shape, dev, dtype)
    affine = torch.empty((S, 6), dtype=torch.float32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    err = kernels.load().sf_epic_fit(
        *(kernels.ptr(t) for t in (seeds, vects, nnf, dis, src, d0, job,
                                   starts, affine, counts)),
        S, K, float(coef_kernel), kernels.stream_ptr(dev))
    kernels.check(err, "epic_fit")
    kernels.count_launch("epic_fit")
    n, n_bad = counts.tolist()
    if n_bad:
        raise ValueError(f"fit_localaffine_cuda: {n_bad} seeds hold a "
                         "neighbour index beyond their job")
    if n:
        with _fallback_lock:
            FIT_FALLBACK_SEEDS += n
    return affine


def apply_localaffine_cuda(affine, labels, starts):
    """`apply_localaffine` of B images through the kernel of
    csrc/epic_fit.cu, on the current stream: labels [B, H, W] int32
    job-local seed indices (< 0 none), starts [B] int32 each image's first
    row of affine [S, 6] float32, all contiguous on the calling thread's
    current CUDA device. Returns flows [B, H, W, 2] float32 there."""
    dev = affine.device
    if dev.type != "cuda":
        raise ValueError(f"apply_localaffine_cuda: tensors on {dev}, "
                         "expected CUDA")
    if labels.dim() != 3:
        raise ValueError(f"labels: expected [B, H, W], got "
                         f"{list(labels.shape)}")
    b, h, w = labels.shape
    for name, t, shape, dtype in (
            ("affine", affine, (len(affine), 6), torch.float32),
            ("labels", labels, (b, h, w), torch.int32),
            ("starts", starts, (b,), torch.int32)):
        kernels.require_cuda(name, t, shape, dev, dtype)
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    err = kernels.load().sf_epic_apply(
        *(kernels.ptr(t) for t in (labels, starts, affine, out)), b, h, w,
        kernels.stream_ptr(dev))
    kernels.check(err, "epic_apply")
    kernels.count_launch("epic_apply")
    return out


def epic(imlab, matches, edges, params: EpicParams = EpicParams(),
         max_iter_dt: int = 256, saliency_map=None, device=None):
    """Sparse-to-dense interpolation of one problem.

    imlab:   [3, H, W] Lab image (rgb_to_lab output), array or tensor
    matches: [N, 4] (x1, y1, x2, y2)
    edges:   [H, W] edge cost map (not modified)
    saliency_map: optional precomputed saliency of imlab
    Returns flow [H, W, 2] float32 (numpy)."""
    return epic_batched([(imlab, matches, edges, saliency_map)], params,
                        max_iter_dt, device)[0]


def epic_batched(jobs, params: EpicParams = EpicParams(),
                 max_iter_dt: int = 256, device=None):
    """EPIC interpolation for a batch of independent problems of one size.

    jobs: list of (imlab, matches, edges, saliency_map-or-None). The two
    geodesic distance transforms (prefilter and interpolation) are one
    batched device call each over the jobs that need them; on CUDA the LA
    fits and apply are one launch each over all the jobs, elsewhere the
    fits run per job on the host. `device`: None = CUDA. Returns a list of
    flow [H, W, 2] float32 arrays."""
    device = device_of(None, device)
    B = len(jobs)
    state = []
    for imlab, matches, edges, saliency_map in jobs:
        h, w = imlab.shape[-2:]
        matches = np.asarray(matches, np.float32).reshape(-1, 4).copy()
        edges = np.asarray(edges, np.float32).copy()

        # 1. rectify
        matches[:, 0] = np.clip(matches[:, 0], 0, w - 1)
        matches[:, 1] = np.clip(matches[:, 1], 0, h - 1)
        matches[:, 2] = np.clip(matches[:, 2], 0, w - 1)
        matches[:, 3] = np.clip(matches[:, 3], 0, h - 1)

        # 2. edge cost offset
        if params.euc:
            edges = edges + params.euc

        # 3. saliency filter; float coordinates truncate toward zero
        if params.saliency_th and len(matches):
            if saliency_map is None:
                lab_t = imlab.to(device) if isinstance(imlab, torch.Tensor) \
                    else torch.tensor(np.asarray(imlab, np.float32),
                                      device=device)
                saliency_map = saliency_fn(lab_t, 0.8, 1.0)
            if isinstance(saliency_map, torch.Tensor):
                saliency_map = saliency_map.cpu().numpy()
            s = np.asarray(saliency_map)
            keep = s[matches[:, 1].astype(int), matches[:, 0].astype(int)] \
                >= params.saliency_th
            matches = matches[keep]
        state.append(dict(matches=matches, edges=edges, hw=(h, w)))

    # 4. consistency prefilter (one batched DT over eligible jobs)
    if params.pref_nn:
        idx = [b for b in range(B) if len(state[b]["matches"]) > 1]
        if idx:
            with phase("epic.prefilter_dt"):
                res = dist_trf_nnfield_batched(
                    [state[b]["matches"][:, :2].astype(np.int32)
                     for b in idx],
                    [state[b]["edges"] for b in idx],
                    [min(params.pref_nn + 1, len(state[b]["matches"]))
                     for b in idx], max_iter_dt, device)
            with phase("epic.prefilter_fit"):
                for b, (nnf, dis, _, _) in zip(idx, res):
                    m = state[b]["matches"]
                    vects = m[:, 2:4] - m[:, :2]
                    disk = _kernelize(dis, params.coef_kernel)
                    est = fit_nadarayawatson(nnf, disk, vects)
                    keep = ((est - vects) ** 2).sum(1) < params.pref_th ** 2
                    state[b]["matches"] = m[keep]

    # 5. geodesic k-NN for the interpolation (one batched DT)
    flows = [None] * B
    idx = [b for b in range(B) if len(state[b]["matches"])]
    for b in range(B):
        if b not in idx:
            h, w = state[b]["hw"]
            flows[b] = np.zeros((h, w, 2), np.float32)
    if idx:
        la_cuda = params.method.upper() == "LA" and device.type == "cuda"
        with phase("epic.main_dt"):
            args = ([state[b]["matches"][:, :2].astype(np.int32)
                     for b in idx],
                    [state[b]["edges"] for b in idx],
                    [min(params.nn, len(state[b]["matches"])) for b in idx],
                    max_iter_dt, device)
            if la_cuda:
                res, labels_t = nnfield_and_labels(*args)
            else:
                res = dist_trf_nnfield_batched(*args)
        if la_cuda:
            ms = [state[b]["matches"] for b in idx]
            with on_device(device):
                with phase("epic.fit_la"):
                    packed = pack_jobs(
                        *([r[i] for r in res] for i in range(4)),
                        [m[:, :2].astype(np.int32) for m in ms],
                        [m[:, 2:4] - m[:, :2] for m in ms], device)
                    affine = fit_localaffine_cuda(*packed,
                                                  params.coef_kernel)
                with phase("epic.apply_la"):
                    starts = packed[-1][:-1]        # each job's first row
                    out = apply_localaffine_cuda(affine, labels_t,
                                                 starts).cpu().numpy()
            for b, flow in zip(idx, out):
                flows[b] = flow
            return flows
        for b, (nnf, dis, labels, _) in zip(idx, res):
            m = state[b]["matches"]
            h, w = state[b]["hw"]
            seeds = m[:, :2].astype(np.int32)
            vects = m[:, 2:4] - m[:, :2]
            with phase("epic.kernelize"):
                disk = _kernelize(dis, params.coef_kernel)

            # 6-7. fit + apply
            if params.method.upper() == "LA":
                with phase("epic.fit_la"):
                    affine = fit_localaffine(nnf, disk,
                                             seeds.astype(np.float32), vects)
                with phase("epic.apply_la"):
                    flow = apply_localaffine(affine, labels, h, w)
            elif params.method.upper() == "NW":
                sv = fit_nadarayawatson(nnf, disk, vects)
                flow = apply_nadarayawatson(sv.astype(np.float32), labels)
            else:
                raise ValueError(
                    f"unknown interpolation method {params.method}")
            flows[b] = flow.astype(np.float32)
    return flows
