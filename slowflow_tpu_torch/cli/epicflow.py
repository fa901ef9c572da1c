"""Standalone EpicFlow CLI on PyTorch (the same contract as
`python -m slowflow_tpu.cli.epicflow`).

Usage:
    python -m slowflow_tpu_torch.cli.epicflow image1 image2 edges matches
        out.flo [-nw] [-p N] [-n N] [-k F] [-i N] [-a F] [-g F] [-d F] [-s F]
        [-sintel | -kitti | -middlebury] [-device cuda|cpu (default: cuda)]

`edges` is a binary float32 H*W cost file, or "auto" for the built-in
detector; `matches` is a DeepMatching-style text file, or "auto" for the
built-in grid matcher. The EPIC interpolation's output is refined by the
two-frame variational solve (its SOR step is the K5 kernel on CUDA).
`-device` defaults to CUDA and raises when torch finds no GPU; `-device cpu`
runs the plain PyTorch twins on the CPU.
"""
from __future__ import annotations

import sys
from dataclasses import replace

import numpy as np
import torch

from ..core.image import rgb_to_lab
from ..epic import EpicParams, epic
from ..epic.edges import detect_edges
from ..epic.matching import grid_matches
from ..io import read_edges, read_image, read_matches, write_flo
from ..runtime import resolve_device
from ..variational.twoframe import TwoFrameParams, variational_twoframe

# flag -> TwoFrameParams field, value type
_FLOW_FLAGS = {"-i": ("niter_outer", int), "-iter": ("niter_outer", int),
               "-a": ("alpha", float), "-alpha": ("alpha", float),
               "-g": ("gamma", float), "-gamma": ("gamma", float),
               "-d": ("delta", float), "-delta": ("delta", float),
               "-s": ("sigma", float), "-sigma": ("sigma", float)}


def _planar(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(np.moveaxis(img, -1, 0), np.float32)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 5:
        print(__doc__)
        return 1

    epic_params = EpicParams()
    flow_params = TwoFrameParams()
    device = None
    i = 5
    while i < len(argv):
        a = argv[i]
        i += 1
        if a in ("-h", "-help"):
            print(__doc__)
        elif a == "-nw":
            epic_params.method = "NW"
        elif a in ("-p", "-prefnn"):
            epic_params.pref_nn = int(argv[i]); i += 1
        elif a in ("-n", "-nn"):
            epic_params.nn = int(argv[i]); i += 1
        elif a == "-k":
            epic_params.coef_kernel = float(argv[i]); i += 1
        elif a in _FLOW_FLAGS:
            field, kind = _FLOW_FLAGS[a]
            flow_params = replace(flow_params, **{field: kind(argv[i])})
            i += 1
        elif a == "-sintel":
            epic_params = EpicParams.sintel()
            flow_params = TwoFrameParams.sintel()
        elif a == "-kitti":
            epic_params = EpicParams.sintel()
            flow_params = TwoFrameParams.kitti()
        elif a == "-middlebury":
            epic_params = EpicParams(pref_nn=15, nn=65, coef_kernel=0.2)
            flow_params = TwoFrameParams.middlebury()
        elif a in ("-device", "--device"):
            device = argv[i]; i += 1
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            print(__doc__)
            return 1
    device = resolve_device(device)

    im1 = torch.as_tensor(_planar(read_image(argv[0])), device=device)
    im2 = torch.as_tensor(_planar(read_image(argv[1])), device=device)
    h, w = im1.shape[1:]
    if argv[2] == "auto":
        edges = detect_edges(im1).cpu().numpy()
    else:
        edges = read_edges(argv[2], w, h)
    if argv[3] == "auto":
        matches = grid_matches(im1, im2)
    else:
        matches = read_matches(argv[3])

    flow = epic(rgb_to_lab(im1), matches, edges, epic_params, device=device)
    wx, wy = variational_twoframe(flow[..., 0], flow[..., 1], im1, im2,
                                  flow_params, device=device)
    write_flo(argv[4], torch.stack([wx, wy], -1).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
