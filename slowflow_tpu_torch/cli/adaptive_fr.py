"""adaptiveFR CLI, stage 1: flow-magnitude quantile for adaptive frame rates,
on PyTorch.

    python -m slowflow_tpu_torch.cli.adaptive_fr -path P -folder F
        [-format FMT] [-scale S] [-skip K] [-samples N] [-step M] [-start F0]
        [-quantil Q] [-raw] [-overwrite] [-sintel] [-subframes] [-threads N]
        [-append FILE] [-device cuda|cpu (default: cuda)]

Same contract as `python -m slowflow_tpu.cli.adaptive_fr`: samples N
low-resolution two-frame EpicFlow estimates across the sequence, computes the
q-quantile of the flow magnitudes (brought back to the recorded resolution
and frame rate), and writes `quantil.dat` (quantile, maximum) and
`results.info` into the sequence folder for stage 2. `-folder` may name a
folder, a file listing folders, or nothing (every folder under `-path`).

All samples go through one batched call each: Lab and edges, the grid
matcher (or `adaptiveFR/tmp/matches_<a>_<b>.dat` when present; likewise
`tmp/edges_<a>.dat`), the EPIC interpolation, and one two-frame variational
solve over every sample (its SOR step is the K5 kernel on CUDA). `-device`
defaults to CUDA and raises when torch finds no GPU; `-device cpu` runs the
plain PyTorch twins on the CPU.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..config import ParameterList
from ..core.image import rgb_to_lab
from ..epic import EpicParams, epic_batched
from ..epic.edges import detect_edges
from ..epic.matching import grid_matches_batched
from ..io import read_edges, read_flo, read_matches, write_flo, write_image
from ..runtime import resolve_device
from ..utils.colorwheel import flow_color_img
from ..utils.phases import phase
from ..variational.twoframe import (TwoFrameParams,
                                    variational_twoframe_batched)
from .common import frame_path, load_frame


def quantile_of_magnitudes(flows, q):
    """q-quantile of |flow| over all pixels of all flows, with the
    reference's index convention. Returns (quantile, maximum)."""
    mags = np.concatenate([np.hypot(f[..., 0], f[..., 1]).ravel()
                           for f in flows])
    mags.sort()
    np_idx = q * mags.size - 1
    if np_idx < mags.size - 1 and np_idx % 2.0 == 0:
        quantil = 0.5 * (mags[int(np_idx)] + mags[int(np_idx) + 1])
    else:
        quantil = mags[int(np.ceil(np_idx))]
    return float(quantil), float(mags[-1])


def estimate_samples(im1s, im2s, edges_list, matches_list, device):
    """EpicFlow with the sintel presets on B pairs [B, 3, H, W] (8-bit
    range): Lab and edges in one call each, matches in one batched call
    (for the pairs whose entry of `matches_list` is None; likewise
    `edges_list`), the EPIC interpolation, then one batched two-frame
    solve. Returns flows [B, H, W, 2] (numpy)."""
    im1 = torch.as_tensor(np.asarray(im1s, np.float32), device=device)
    im2 = torch.as_tensor(np.asarray(im2s, np.float32), device=device)
    with phase("af.preprocess"):
        lab = rgb_to_lab(im1)
        edges_all = detect_edges(im1).cpu().numpy()
    missing = [i for i, m in enumerate(matches_list) if m is None]
    matches = list(matches_list)
    if missing:
        with phase("af.matches"):
            for i, m in zip(missing, grid_matches_batched(im1[missing],
                                                          im2[missing])):
                matches[i] = m
    jobs = [(lab[i], matches[i],
             edges_all[i] if edges_list[i] is None else edges_list[i], None)
            for i in range(len(matches))]
    with phase("af.epic"):
        inits = epic_batched(jobs, EpicParams.sintel(), device=device)
    with phase("af.twoframe"):
        wx0 = torch.as_tensor(np.stack([f[..., 0] for f in inits]),
                              device=device)
        wy0 = torch.as_tensor(np.stack([f[..., 1] for f in inits]),
                              device=device)
        wx, wy = variational_twoframe_batched(wx0, wy0, im1, im2,
                                              TwoFrameParams.sintel())
        out = torch.stack([wx, wy], -1).cpu().numpy()
    return out


def estimate_pair(im1, im2, edges=None, matches=None, *, device=None):
    """One low-resolution EpicFlow estimate with the sintel presets: B = 1
    of `estimate_samples`. im1 / im2 [3, H, W] in the 8-bit range; edges /
    matches None means they are computed. `device`: None means CUDA (which
    raises when torch finds no GPU). Returns flow [H, W, 2] (numpy)."""
    return estimate_samples(np.asarray(im1)[None], np.asarray(im2)[None],
                            [edges], [matches], resolve_device(device))[0]


def run_folder(path, folder, fmt="%07i.tif", scale=0.25, skip=2, samples=40,
               sample_step=10, start=0, q=0.90, raw=False, sintel=False,
               subframes=False, overwrite=False, append="",
               device=None) -> float:
    device = resolve_device(device)
    params = ParameterList()
    params.insert("verbose", "0", True)
    params.insert("scale", "1.0", True)
    if raw:
        params.insert("raw", "1", True)
        params.insert("raw_demosaicing", "2", True)
    params.file = os.path.join(path, folder) + "/"
    params.Jets = 1

    seq_path = params.file
    output = os.path.join(seq_path, "adaptiveFR") + "/"
    os.makedirs(output + "tmp/", exist_ok=True)
    os.makedirs(output + "sequence/", exist_ok=True)

    fmt_flow = os.path.splitext(fmt)[0]
    if sintel and not subframes:
        start = start * 1000
    params.sequence_start = start
    red_loc = params.split_parameter("raw_red_loc", "1,0")
    t_all = time.time()

    # ------------------------------------------------------- gather samples
    records = []            # (seq_start, flo_file, (im1, im2) or None)
    seq_start = start
    for it in range(samples):
        if it > 0:
            seq_start += params.Jets * sample_step
        params.sequence_start = seq_start
        if not sintel:
            flo_file = os.path.join(output, fmt_flow % seq_start + ".flo")
        else:
            flo_file = os.path.join(output, fmt_flow % (
                seq_start // 1000, seq_start % 1000) + ".flo")

        imgs = None
        if overwrite or not os.path.exists(flo_file):
            imgs = []
            for f in range(2):
                p = frame_path(seq_path, fmt, seq_start, f * skip, sintel)
                if not os.path.exists(p):
                    print(f"Could not find {p}!", file=sys.stderr)
                    imgs = None
                    break
                with phase("af.read_frames"):
                    img = load_frame(p, params, scale, red_loc, device)
                if img.max() > 255.0:
                    img = img / 255.0   # 16-bit -> 8-bit
                imgs.append(np.clip(img, 0, 255))
            if imgs is None:
                continue
        records.append((seq_start, flo_file, imgs))

    # ------------------------------------- batched estimation of all samples
    todo = [r for r in records if r[2] is not None]
    t_est = time.time()
    refined = {}
    if todo:
        matches, edges = [], []
        for seq_start_i, _, imgs in todo:
            mf = output + f"tmp/matches_{seq_start_i}_{seq_start_i + skip}.dat"
            matches.append(read_matches(mf) if os.path.exists(mf) else None)
            ef = output + f"tmp/edges_{seq_start_i}.dat"
            edges.append(read_edges(ef, imgs[0].shape[2], imgs[0].shape[1])
                         if os.path.exists(ef) else None)
        flows = estimate_samples(np.stack([r[2][0] for r in todo]),
                                 np.stack([r[2][1] for r in todo]),
                                 edges, matches, device)
        for (seq_start_i, _, _), flow in zip(todo, flows):
            refined[seq_start_i] = flow
    t_est = time.time() - t_est

    # ----------------------------------------------------- outputs + quantile
    flows = []
    results = ["frame\ttime\n\n"]
    per_sample = t_est / max(1, len(todo))
    for seq_start_i, flo_file, imgs in records:
        if seq_start_i in refined:
            flow = refined[seq_start_i]
            write_flo(flo_file, flow)
            results.append(f"{seq_start_i}\t{per_sample:.1f}\n")
        else:
            flow = read_flo(flo_file)
            results.append(f"{seq_start_i}\t0.0\n")
        write_image(output + f"tmp/frame_{seq_start_i}.png",
                    flow_color_img(flow[..., 0], flow[..., 1]))
        # back to the recorded resolution and frame rate
        flows.append(flow / (scale * skip))

    if not flows:
        print(f"{folder}: no samples estimated", file=sys.stderr)
        return -1.0

    quantil, maxq = quantile_of_magnitudes(flows, q)
    print(f"Quantil: {quantil}")

    with open(output + "results.info", "w") as fh:
        fh.write("Adaptive Frame rate\n\n")
        fh.write(f"samples\t{len(flows)}\n")
        fh.write(f"sample_step\t{sample_step}\n")
        fh.write(f"skip\t{skip}\n")
        fh.write(f"{q} quantil\t{quantil}\n")
        fh.write(f"max\t{maxq}\n")

    target = append if append else os.path.join(seq_path, "quantil.dat")
    with open(target, "a" if append else "w") as fh:
        fh.write(f"{quantil}\n{maxq}\n")
    print(f"(took {time.time() - t_all:.1f}s)")
    return quantil


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = dict(path="", folder="", fmt="%07i.tif", scale=0.25, skip=2,
                samples=40, sample_step=10, start=0, q=0.90, raw=False,
                sintel=False, subframes=False, overwrite=False, append="",
                device=None)
    threads = 1
    i = 0
    while i < len(argv):
        a = argv[i]
        i += 1
        if a in ("-h", "-help"):
            print(__doc__)
            return 0
        elif a == "-path":
            opts["path"] = argv[i]; i += 1
        elif a == "-folder":
            opts["folder"] = argv[i]; i += 1
        elif a == "-format":
            opts["fmt"] = argv[i]; i += 1
        elif a == "-scale":
            opts["scale"] = float(argv[i]); i += 1
        elif a == "-skip":
            opts["skip"] = max(1, int(argv[i])); i += 1
        elif a == "-samples":
            opts["samples"] = int(argv[i]); i += 1
        elif a == "-step":
            opts["sample_step"] = int(argv[i]); i += 1
        elif a == "-start":
            opts["start"] = int(argv[i]); i += 1
        elif a == "-quantil":
            opts["q"] = float(argv[i]); i += 1
        elif a == "-raw":
            opts["raw"] = True
        elif a == "-sintel":
            opts["sintel"] = True
        elif a == "-subframes":
            opts["subframes"] = True
        elif a == "-overwrite":
            opts["overwrite"] = True
        elif a == "-append":
            opts["append"] = argv[i]; i += 1
        elif a == "-threads":
            threads = max(1, int(argv[i])); i += 1
        elif a in ("-device", "--device"):
            opts["device"] = argv[i]; i += 1
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            print(__doc__)
            return 1
    opts["device"] = resolve_device(opts["device"])

    path = opts.pop("path")
    folder = opts.pop("folder")
    if not folder:
        folders = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d))
                         and not d.startswith("."))
    elif os.path.isdir(os.path.join(path, folder)):
        folders = [folder]
    else:
        with open(folder) as fh:
            folders = [ln.strip() for ln in fh
                       if os.path.isdir(os.path.join(path, ln.strip()))]

    # folders are independent; a thread pool overlaps one folder's host
    # work with another's device calls. Output order is preserved.
    if threads > 1 and len(folders) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(threads, len(folders))) as ex:
            qvs = list(ex.map(lambda f: run_folder(path, f, **opts),
                              folders))
    else:
        qvs = [run_folder(path, f, **opts) for f in folders]
    overview = [f"{f}\t{opts['q']} quantil\t{qv}\n"
                for f, qv in zip(folders, qvs)]

    with open(os.path.join(path, "results.info"), "w") as fh:
        fh.write("Adaptive Frame rate\n\n")
        fh.write(f"samples\t{opts['samples']}\n")
        fh.write(f"sample_step\t{opts['sample_step']}\n")
        fh.write(f"skip\t{opts['skip']}\n\n")
        fh.writelines(overview)
    print("Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
