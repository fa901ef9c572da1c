"""slow_flow CLI, stage 2: per-jet multi-frame flow estimation on PyTorch.

    python -m slowflow_tpu_torch.cli.slow_flow <cfg> [-overwrite] [-resume]
        [-fr K] [-jet J] [-batch B] [-threads N]
        [-device cuda|cpu (default: cuda)]

Same contract as `python -m slowflow_tpu.cli.slow_flow`: reads the
tab-separated cfg, `adaptiveFR.dat` and `<sequence>/quantil.dat`, derives the
adaptive frame rates and the matcher's search radius, and for each jet solves
the multi-frame variational energy forward and backward, writing Middlebury
`.flo` files, occlusion `.pbm` maps, flow visualizations, `results.info` and
a `config.cfg` snapshot with the sequence normalization statistics. Jets are
solved `-batch` at a time as one batched call; with several CUDA devices a
batch whose jets divide evenly over them is split across them
(`variational_mt_sharded`).

With `deep_matching 1` (the default) each solve starts from the EPIC
initialization: Lab, saliency and edge maps of the whole window in batched
calls on the 8-bit frames (staged to the device once), grid matches per jet
group (or `tmp/matches_<a>_<b>.dat` when present), `tmp/edges_<a>.dat` when
present, and the EPIC interpolation. The init of a group runs on a prefetch
thread (`-threads N` workers, default 2) with its own CUDA stream while the
device solves the previous group. `deep_matching 0` starts from zero flow.
`-device` defaults to CUDA and raises when torch finds no GPU; `-device cpu`
runs the kernels' plain PyTorch twins on the CPU. `-deep_settings` is
accepted and ignored. SF_PROF=1 prints the per-phase seconds.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import ParameterList, Verbosity
from ..core.image import (normalize_sequence, resize_bilinear, rgb_to_lab,
                          saliency)
from ..epic import EpicParams, epic_batched
from ..epic.edges import detect_edges
from ..epic.matching import grid_matches_batched
from ..io import (read_edges, read_flo, read_matches, write_flo, write_image,
                  write_pbm)
from ..parallel.mesh import make_mesh
from ..runtime import resolve_device
from ..utils.colorwheel import flow_color_img
from ..utils.demosaic import raw_weighting
from ..utils.metrics import compute_epe
from ..utils.phases import add as phase_add
from ..utils.phases import phase
from ..utils.phases import report as phase_report
from ..variational.multiframe import (variational_mt_batched,
                                      variational_mt_sharded)
from ..variational.params import MultiFrameParams
from .common import frame_path, load_frame, unique_output_dir

# quantil.dat's maximum flow times this is the largest displacement a jet's
# matcher searches for
MAX_FLOW_SCALE = 3.0

DEFAULTS = {
    "verbose": "0", "threads": "1",
    "16bit": "1", "raw": "1", "raw_weight": "1", "raw_demosaicing": "1",
    "raw_red_loc": "1,0",
    "Jets": "1", "adaptive": "1", "max_fps": "200", "ref_fps": "20",
    "scale": "1.0", "sigma": "0.0", "deep_matching": "1", "dm_scale": "1.0",
    "slow_flow_method": "symmetric", "slow_flow_S": "2",
    "slow_flow_dataterm": "1", "slow_flow_smoothing": "1",
    "slow_flow_alpha": "4.0", "slow_flow_gamma": "6.0",
    "slow_flow_delta": "1.0",
    "slow_flow_rho_0": "1", "slow_flow_rho_1": "1",
    "slow_flow_omega_0": "0", "slow_flow_omega_1": "2",
    "slow_flow_layers": "1", "slow_flow_p_scale": "0.9",
    "slow_flow_niter_alter": "10", "slow_flow_niter_graphc": "10",
    "slow_flow_niter_outer": "10", "slow_flow_thres_outer": "1e-5",
    "slow_flow_niter_inner": "1", "slow_flow_thres_inner": "1e-5",
    "slow_flow_niter_solver": "30", "slow_flow_sor_omega": "1.9",
    "slow_flow_occlusion_reasoning": "1", "slow_flow_occlusion_penalty": "0.1",
    "slow_flow_occlusion_alpha": "0.1", "slow_flow_output_occlusions": "1",
    "slow_flow_robust_color": "1", "slow_flow_robust_color_eps": "0.001",
    "slow_flow_robust_color_truncation": "0.5",
    "slow_flow_robust_reg": "1", "slow_flow_robust_reg_eps": "0.001",
    "slow_flow_robust_reg_truncation": "0.5",
}


def read_adaptive_table(search_dirs):
    """adaptiveFR.dat tuning table: (hfr_quantil, lfr_rate, found)."""
    hfr_quantil, lfr_rate = 2.0, 4
    for d in search_dirs:
        path = os.path.join(d, "adaptiveFR.dat")
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            for line in fh:
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                if parts[0] == "opt_hfr_quantil":
                    hfr_quantil = float(parts[1])
                elif parts[0] == "opt_lfr_rate":
                    lfr_rate = int(float(parts[1]))
        return hfr_quantil, lfr_rate, True
    return hfr_quantil, lfr_rate, False


def compute_rates(quantil, hfr_quantil, lfr_rate_mult, keyframes, steps):
    """Adaptive high / low frame-rate derivation."""
    if keyframes == 0:
        hfr_rate = max(1.0, round(hfr_quantil / quantil))
        lfr_rate = hfr_rate * (hfr_rate * lfr_rate_mult)
        lfr_rate = hfr_rate * round(lfr_rate / hfr_rate)
        return int(hfr_rate), int(lfr_rate)
    hfr_rate = int(max(1.0, round(hfr_quantil / quantil)))
    while hfr_rate < keyframes and keyframes % (hfr_rate * steps) != 0:
        hfr_rate += 1
    lfr_rate = min(keyframes, hfr_rate * lfr_rate_mult)
    while ((lfr_rate * steps < keyframes
            and (keyframes % (lfr_rate * steps) != 0
                 or (keyframes % (lfr_rate * steps) == 0
                     and (lfr_rate * steps) % (hfr_rate * steps) != 0)))
           or (lfr_rate * steps >= keyframes
               and (lfr_rate * steps) % (hfr_rate * steps) != 0)):
        lfr_rate += 1
    return hfr_rate, min(keyframes // steps, lfr_rate)


def _epic_post(flow, target_hw, steps):
    """Rescale an EPIC flow [h, w, 2] to the working size and divide it by
    `steps` (the init is per frame of the jet). Returns (wx, wy) float32."""
    h, w = target_hw
    fh, fw = h / flow.shape[0], w / flow.shape[1]
    if (fh, fw) != (1.0, 1.0):
        planar = torch.as_tensor(np.ascontiguousarray(
            np.moveaxis(flow, -1, 0), np.float32))
        flow = np.moveaxis(resize_bilinear(planar, h, w).numpy(), 0, -1)
    wx = flow[..., 0] * fw / steps
    wy = flow[..., 1] * fh / steps
    return wx.astype(np.float32), wy.astype(np.float32)


def stage_window_8bit(frames8: np.ndarray, device) -> torch.Tensor:
    """The 8-bit EPIC window [F, 3, H, W] on the device, staged once: uint8
    when the values are exactly representable (8-bit sources at scale 1),
    float32 otherwise."""
    arr = np.asarray(frames8, np.float32)
    if arr.min() >= 0.0 and arr.max() <= 255.0 \
            and not np.any(arr != np.floor(arr)):
        return torch.as_tensor(arr.astype(np.uint8), device=device)
    return torch.as_tensor(arr, device=device)


def preprocess_frames(frames8: torch.Tensor, chunk: int = 64):
    """Lab, saliency and edge maps of every window frame, batched over the
    frames in chunks of `chunk` (which bounds the temporaries).

    frames8: [F, 3, H, W] device tensor (uint8 or float32). Returns (lab
    [F, 3, H, W] on the device, saliency [F, H, W] and edges [F, H, W] as
    host arrays: the EPIC interpolation reads them on the host)."""
    labs, sals, edges = [], [], []
    for s in range(0, frames8.shape[0], chunk):
        stack = frames8[s:s + chunk].float()
        lab = rgb_to_lab(stack)
        labs.append(lab)
        sals.append(saliency(lab, 0.8, 1.0).cpu().numpy())
        edges.append(detect_edges(stack).cpu().numpy())
    return (torch.cat(labs), np.concatenate(sals), np.concatenate(edges))


def run(cfg_path: str, overwrite=False, resume=False, selected_fr=-1,
        selected_jet=-1, threads=None, batch=1, device=None, *,
        devices=None) -> int:
    """The CLI's body. `devices`: the devices a jet group is split over
    (`parallel.mesh.make_mesh`); by default every visible CUDA device when
    `device` is CUDA and there are several, else none."""
    device = resolve_device(device)
    if devices is not None:
        mesh = make_mesh(devices=devices)
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = make_mesh()
    else:
        mesh = None
    params = ParameterList()
    for k, v in DEFAULTS.items():
        params.insert(k, v, overwrite=True)
    params.read(cfg_path)

    enable_dm = params.parameter("deep_matching", type=bool)
    scale = params.parameter("scale", "1.0", float)
    start = params.sequence_start
    steps = params.parameter("slow_flow_S", type=int) - 1
    ref = steps
    max_fps = params.parameter("max_fps", "1", int)
    sintel = params.parameter("sintel", "0", bool)
    subframes = params.parameter("subframes", "0", bool)

    seq_dir, fmt = os.path.split(params.file)
    params.file = seq_dir + "/"
    params.insert("format", fmt, True)
    fmt_flow = os.path.splitext(fmt)[0]
    if sintel and not subframes:
        start *= 1000
    params.sequence_start = start
    params.output = unique_output_dir(params.output, resume, overwrite)

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    hfr_quantil, lfr_rate_mult, have_table = read_adaptive_table(
        [os.path.dirname(os.path.abspath(cfg_path)), os.getcwd(), repo_root])
    adaptive = have_table and params.parameter("adaptive", "0", bool)

    # the matcher's search radius follows max_flow: the cfg's, else
    # quantil.dat's second line (its maximum) scaled to the jet's frame
    # distance, else 50
    max_flow = 50.0
    if params.exists("max_flow"):
        max_flow = max(5.0, params.parameter("max_flow", type=float))
    orig_max_flow = 0.0
    hfr_rate, lfr_rate = 1, 4
    qf = os.path.join(seq_dir, "quantil.dat")
    if not params.exists("max_flow") and os.path.exists(qf):
        with open(qf) as fh:
            lines = [ln.strip() for ln in fh if ln.strip()]
        quantil = float(lines[0])
        orig_max_flow = MAX_FLOW_SCALE * (
            float(lines[1]) if len(lines) > 1 else quantil)
        if adaptive:
            keyframes = int(params.parameter("max_fps", type=float)
                            // params.parameter("ref_fps", type=float))
            hfr_rate, lfr_rate = compute_rates(
                quantil, hfr_quantil, lfr_rate_mult, keyframes, steps)
            print(f"hfr_rate {hfr_rate}\nlfr_rate {lfr_rate}")
        else:
            skip = max_fps // max(1, params.parameter(
                "jet_fps", str(max_fps), int))
            max_flow = max(5.0, orig_max_flow * scale * ref * skip)
    else:
        adaptive = False

    start_fr, end_fr = 0, 1 + int(adaptive)
    if selected_fr >= 0:
        start_fr, end_fr = selected_fr, selected_fr + 1
    for ad_fr in range(start_fr, end_fr):
        cfg = ParameterList(clone=params)
        if adaptive:
            rate = hfr_rate if ad_fr == 0 else lfr_rate
            cfg.output = os.path.join(
                cfg.output, "high_fr" if ad_fr == 0 else "low_fr") + "/"
            cfg.insert("jet_fps", str(max_fps // rate), True)
            skip = rate
            max_flow_j = max(5.0, orig_max_flow * scale * ref * rate)
        else:
            skip = int(max_fps / cfg.parameter("jet_fps", str(max_fps), int))
            max_flow_j = max_flow
        # above 150 px the reference also halves its DeepMatching scale
        # (dm_scale), which the built-in matcher does not have
        if enable_dm and max_flow_j > 150:
            max_flow_j = max(5.0, 0.5 * max_flow_j)
        _run_one_rate(cfg, fmt, fmt_flow, start, steps, skip, scale, sintel,
                      resume, selected_jet, batch, device, enable_dm,
                      max_flow_j, threads, mesh)
    print("Done!")
    return 0


def matcher_radius(max_flow: float) -> int:
    """The grid matcher's search radius for a jet's max_flow."""
    return int(min(64, max(8, math.ceil(max_flow))))


def _run_one_rate(cfg, fmt, fmt_flow, start, steps, skip, scale, sintel,
                  resume, selected_jet, batch, device, enable_dm=False,
                  max_flow_j=50.0, threads=None, mesh=None):
    ref = steps
    jets = cfg.Jets
    frames = 1 + (jets + 2) * steps
    start_j, end_j = 0, jets
    start_f, end_f = 0, frames
    if resume and selected_jet >= 0:
        start_f = selected_jet * steps
        end_f = min(frames, 1 + (selected_jet + 3) * steps)
        start_j, end_j = selected_jet, min(jets, selected_jet + 1)

    os.makedirs(cfg.output + "sequence/", exist_ok=True)
    os.makedirs(cfg.output + "tmp/", exist_ok=True)
    if cfg.parameter("slow_flow_occlusion_reasoning", "0", bool):
        os.makedirs(cfg.output + "occlusion/", exist_ok=True)
    red_loc = cfg.split_parameter("raw_red_loc", "0,0")
    bit16 = cfg.parameter("16bit", "0", bool)

    seq = {}
    for f in range(start_f, end_f):
        path = frame_path(cfg.file, fmt, start, (f - ref) * skip, sintel)
        print(f"Reading {path}...")
        with phase("sf.read_frames"):
            seq[f] = load_frame(path, cfg, scale, red_loc, device)
        if cfg.verbosity(Verbosity.WRITE_FILES):
            write_image(frame_path(cfg.output + "sequence/", "frame_%i.png",
                                   start, (f - ref) * skip, False),
                        np.moveaxis(seq[f], 0, -1), bit16=bit16)
    h, w = seq[start_f].shape[1:]

    channel_w = np.ones((3, h, w), np.float32)
    if cfg.exists("raw") and cfg.parameter("raw", "0", bool):
        channel_w = raw_weighting(h, w, red_loc[0], red_loc[1],
                                  cfg.parameter("raw_weight", "1.0", float))

    gt = {}
    if cfg.file_gt:
        os.makedirs(cfg.output + "gt/", exist_ok=True)
        for j in range(start_j, end_j):
            path = frame_path("", cfg.file_gt, start, j * steps, sintel)
            if not os.path.exists(path):
                continue
            g = read_flo(path)
            if scale != 1:
                nh, nw = int(g.shape[0] * scale), int(g.shape[1] * scale)
                planar = torch.as_tensor(np.ascontiguousarray(
                    np.moveaxis(g, -1, 0), np.float32))
                g = np.moveaxis(resize_bilinear(planar, nh, nw).numpy(),
                                0, -1) * scale
            gt[j] = g
            stem = cfg.output + f"gt/flow_{cfg.sequence_start + j * steps:05d}"
            write_flo(stem + ".flo", g)
            write_image(stem + ".png", flow_color_img(g[..., 0], g[..., 1]))

    # 8-bit copies for the EPIC init, before normalization; 16-bit input is
    # divided by 255 and saturated
    order = list(range(start_f, end_f))
    if enable_dm:
        frames8 = np.stack([np.clip(seq[f] / 255.0, 0, 255) if bit16
                            else seq[f] for f in order])

    stack = np.stack([seq[f] for f in order])
    stack, avg, std = normalize_sequence(stack)
    for c in range(3):
        cfg.insert(f"slow_flow_img_norm_avg_{c + 1}", repr(float(avg[c])), True)
        cfg.insert(f"slow_flow_img_norm_std_{c + 1}", repr(float(std[c])), True)
    with open(cfg.output + "config.cfg", "w") as fh:
        fh.write("# SlowFlow variational estimation\n")
        fh.write(cfg.cfg_string())

    p = MultiFrameParams.from_parameter_list(cfg)
    stack_dev = torch.as_tensor(stack, device=device)
    cw_dev = torch.as_tensor(channel_w, device=device)
    avg_dev = torch.as_tensor(np.asarray(avg, np.float32), device=device)
    std_dev = torch.as_tensor(np.asarray(std, np.float32), device=device)

    # per-frame Lab / saliency / edges of the whole window, batched; the
    # 8-bit window goes to the device once and the matcher slices it there
    pre = {f: i for i, f in enumerate(order)}
    if enable_dm:
        with phase("sf.stage_window8"):
            seq8_dev = stage_window_8bit(frames8, device)
        with phase("sf.preprocess_frames"):
            lab_all, sal_all, edges_all = preprocess_frames(seq8_dev)

    def window_idx(j, backward):
        """Window frames (indices into stack) around jet j; the backward pass
        reads the next window reversed."""
        idx = list(range(j * steps, j * steps + 2 * ref + 1))
        if backward:
            idx = [i + steps for i in reversed(idx)]
        return [i - start_f for i in idx]

    def jet_frames(j, backward):
        a, b = j * steps + ref, j * steps + 2 * ref
        return (b, a) if backward else (a, b)

    def frame_no(f):
        return cfg.sequence_start + (f - ref) * skip

    def group_matches(group, backward):
        """Matches of every jet in a group: `tmp/matches_<a>_<b>.dat` when
        present, else one batched grid-match call for the rest."""
        out, missing = {}, []
        for j in group:
            a, b = jet_frames(j, backward)
            mf = cfg.output + f"tmp/matches_{frame_no(a)}_{frame_no(b)}.dat"
            if os.path.exists(mf):
                out[j] = read_matches(mf)
            else:
                missing.append((j, a, b))
        if missing:
            res = grid_matches_batched(
                seq8_dev[[pre[a] for _, a, _ in missing]],
                seq8_dev[[pre[b] for _, _, b in missing]],
                radius=matcher_radius(max_flow_j))
            for (j, _, _), m in zip(missing, res):
                out[j] = m
        return out

    def epic_jobs(group, backward, matches):
        """EPIC jobs of a group from the per-frame maps; `tmp/edges_<a>.dat`
        replaces the built-in edges when present."""
        jobs = []
        for j in group:
            a, _ = jet_frames(j, backward)
            ef = cfg.output + f"tmp/edges_{frame_no(a)}.dat"
            edges = read_edges(ef, w, h) if os.path.exists(ef) \
                else edges_all[pre[a]]
            jobs.append((lab_all[pre[a]], matches[j], edges,
                         sal_all[pre[a]]))
        return jobs

    side = None
    if enable_dm and device.type == "cuda":
        # the prefetch thread's device work must not queue behind the
        # solve's launches on the default stream
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))

    def compute_inits(group, backward):
        """The EPIC init of one jet group (matches, interpolation, rescale),
        run on the prefetch thread."""
        ctx = torch.cuda.stream(side) if side is not None \
            else contextlib.nullcontext()
        with ctx:
            with phase("sf.matches"):
                matches = group_matches(group, backward)
            with phase("sf.epic"):
                flows = epic_batched(epic_jobs(group, backward, matches),
                                     EpicParams.sintel(), device=device)
        with phase("sf.epic_post"):
            inits = [_epic_post(f, (h, w), steps) for f in flows]
        return (np.stack([ini[0] for ini in inits]),
                np.stack([ini[1] for ini in inits]))

    def output_name(j, backward):
        off = (j * steps + (steps if backward else 0)) * skip
        name = fmt_flow % ((start + off, 0) if sintel else (start + off))
        return os.path.join(cfg.output,
                            name + ("_back" if backward else "") + ".flo")

    tasks = []
    for backward in (False, True):
        pending = []
        for j in range(start_j, end_j):
            if resume and os.path.exists(output_name(j, backward)):
                print(f"{'Backward' if backward else 'Forward'} flow for jet "
                      f"{j} already exists!")
                continue
            pending.append(j)
        step = max(1, batch)
        tasks += [(backward, pending[i:i + step])
                  for i in range(0, len(pending), step)]

    executor = ThreadPoolExecutor(max_workers=max(1, threads or 2)) \
        if enable_dm else None
    init_futs = [executor.submit(compute_inits, group, backward)
                 for backward, group in tasks] if enable_dm else None

    one_direction = cfg.exists("method") and cfg.parameter("method") == "forward"
    results = ["frame\ttime\n"]
    try:
        for ti, (backward, group) in enumerate(tasks):
            t0 = time.time()
            n = len(group)
            with phase("sf.window_gather"):
                windows = stack_dev[[i for j in group
                                     for i in window_idx(j, backward)]]
                windows = windows.view(n, 2 * ref + 1, 3, h, w)
            if enable_dm:
                with phase("sf.init_wait"):
                    wx0, wy0 = init_futs[ti].result()
                wx0 = torch.as_tensor(wx0, device=device)
                wy0 = torch.as_tensor(wy0, device=device)
            else:
                wx0 = wy0 = torch.zeros((n, h, w), device=device)
            pb = MultiFrameParams(**{**p.__dict__, "one_direction": True}) \
                if backward and one_direction else p
            terms = (cw_dev.expand(n, 3, h, w), avg_dev.expand(n, 3),
                     std_dev.expand(n, 3))
            with phase("sf.solve"):
                # several devices: the group's jets split over them when
                # they divide evenly (the JAX CLI's rule), else one batch
                if mesh is not None and len(mesh) > 1 \
                        and n % len(mesh) == 0:
                    wx, wy, occ = variational_mt_sharded(
                        wx0, wy0, windows, pb, mesh, *terms)
                else:
                    wx, wy, occ = variational_mt_batched(
                        wx0, wy0, windows, pb, *terms, device=device)
                wx = wx.cpu().numpy() * steps
                wy = wy.cpu().numpy() * steps
                occ = occ.cpu().numpy()
            dt = time.time() - t0
            phase_add("sf.batch", dt)

            for k, j in enumerate(group):
                flow = np.stack([wx[k], wy[k]], -1)
                with phase("sf.write_flo"):
                    write_flo(output_name(j, backward), flow)
                if not backward and j in gt:
                    results.append(f"# jet {j} EPE vs gt: "
                                   f"{compute_epe(flow, gt[j]):.4f}\n")
                if not backward:
                    frame_out = start + j * steps * skip
                    if p.occlusion_reasoning and cfg.parameter(
                            "slow_flow_output_occlusions", "0", bool):
                        write_pbm(cfg.output
                                  + f"occlusion/frame_{frame_out}.pbm",
                                  ((occ[k] + 1.0) * 0.5 * 255).astype(
                                      np.uint8))
                    with phase("sf.vis_png"):
                        write_image(cfg.output + f"frame_{frame_out}.png",
                                    flow_color_img(wx[k], wy[k]))
                results.append(f"{j * steps * skip}\t {dt / n:.1f}\n")
                print(f"{'Backward' if backward else 'Forward'} flow jet {j} "
                      f"finished! ({dt / n:.1f} s)")
    finally:
        if executor is not None:
            executor.shutdown(wait=True, cancel_futures=True)

    with open(cfg.output + "results.info", "w") as fh:
        fh.write("SlowFlow variational estimation\n\n")
        fh.writelines(results)
        times = [float(r.split("\t")[1]) for r in results[1:]
                 if "\t" in r and not r.startswith("#")]
        if times:
            fh.write(f"\n\navg\t{sum(times) / len(times):.1f}s\n")
    phase_report()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cfg_path = argv[0]
    if not os.path.exists(cfg_path):
        print(f"Couldn't find {cfg_path}!", file=sys.stderr)
        return -1
    kw = {}
    i = 1
    while i < len(argv):
        a = argv[i]
        i += 1
        if a == "-overwrite":
            kw["overwrite"] = True
        elif a == "-resume":
            kw["resume"] = True
        elif a == "-deep_settings":
            i += 1
        elif a == "-threads":
            kw["threads"] = int(argv[i])
            i += 1
        elif a == "-fr":
            kw["selected_fr"] = int(argv[i])
            i += 1
        elif a == "-jet":
            kw["selected_jet"] = int(argv[i])
            kw["resume"] = True
            i += 1
        elif a == "-batch":
            kw["batch"] = int(argv[i])
            i += 1
        elif a in ("-device", "--device"):
            kw["device"] = argv[i]
            i += 1
        elif a in ("-h", "-help"):
            print(__doc__)
            return 0
        else:
            print(f"unknown argument {a}", file=sys.stderr)
    return run(cfg_path, **kw)


if __name__ == "__main__":
    sys.exit(main())
