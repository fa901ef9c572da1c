"""Shared CLI helpers: frame naming (sintel numbering included), frame
loading (demosaic / crop / scale) with a torch blur + resize, and
collision-free output folders."""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core.conv import gaussian_blur
from ..core.image import resize_bilinear
from ..io.images import read_image
from ..runtime import resolve_device
from ..utils.demosaic import (bayer2rgb, bayer2rgb_green_ratio,
                              bayer2rgb_hamilton_adams)


def sintel_frame_name(start: int, offset: int):
    """Sintel's two-level frame numbering (slow_flow.cpp:453-465): frame ids
    encode (sequence_frame * 1000 + high-speed subframe), 42 subframes per
    24fps frame. Returns (sintel_frame, hfr_frame)."""
    sintel_frame = start // 1000
    hfr_frame = offset + (start % 1000)
    while hfr_frame < 0:
        sintel_frame -= 1
        hfr_frame += 42
    while hfr_frame > 41:
        sintel_frame += 1
        hfr_frame -= 42
    return sintel_frame, hfr_frame


def frame_path(sequence_path: str, fmt: str, start: int, offset: int,
               sintel: bool) -> str:
    if not sintel:
        return os.path.join(sequence_path, fmt % (start + offset))
    sf, hf = sintel_frame_name(start, offset)
    return os.path.join(sequence_path, fmt % (sf, hf))


def unique_output_dir(path: str, resume: bool, overwrite: bool) -> str:
    """Collision-avoiding output dir (slow_flow.cpp:253-266): suffix _N."""
    path = path.rstrip("/")
    if not resume and not overwrite:
        num = 1
        new_path = path
        while os.path.exists(new_path):
            new_path = f"{path}_{num}"
            num += 1
        path = new_path
    return path + "/"


def gaussian_resize(img: np.ndarray, scale: float,
                    device: torch.device) -> np.ndarray:
    """Blur (sigma = 1/sqrt(2*scale)) then bilinear resize: the reference's
    anti-aliased downscale. img is [H, W, C] or [H, W]."""
    if scale == 1:
        return img
    planar = np.moveaxis(img, -1, 0) if img.ndim == 3 else img[None]
    arr = torch.as_tensor(np.ascontiguousarray(planar, np.float32),
                          device=device)
    nh = int(round(arr.shape[-2] * scale))
    nw = int(round(arr.shape[-1] * scale))
    out = resize_bilinear(gaussian_blur(arr, 1.0 / math.sqrt(2 * scale)),
                          nh, nw).cpu().numpy()
    return np.moveaxis(out, 0, -1) if img.ndim == 3 else out[0]


def load_frame(path: str, params, scale: float, red_loc=(1, 0),
               device: torch.device | str | None = None,
               apply_scale: bool = True) -> np.ndarray:
    """Read one frame, demosaic raw Bayer input, crop, rescale (the blur
    and resize run on `device`; None means CUDA, as `resolve_device`
    decides). Returns planar float32 [3, H, W] in the native intensity
    range."""
    device = resolve_device(device)
    img = read_image(path)
    raw = params.exists("raw") and params.parameter("raw", "0", bool)
    if raw and img.ndim == 2:
        mode = params.parameter("raw_demosaicing", "0", int)
        if mode == 0:
            img = bayer2rgb_green_ratio(img, red_loc[0], red_loc[1])
        elif mode == 1:
            img = bayer2rgb_hamilton_adams(img, red_loc[0], red_loc[1])
        else:
            img8 = img / 256.0 if img.max() > 255.0 else img
            img = bayer2rgb(np.clip(img8, 0, 255), red_loc[0], red_loc[1])
    elif img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)

    cx, cy = params.center
    ex, ey = params.extent
    if ex > 0 or ey > 0:
        img = img[cy - ey // 2:cy + ey // 2, cx - ex // 2:cx + ex // 2]
    if apply_scale and scale != 1:
        img = gaussian_resize(img, scale, device)
    return np.ascontiguousarray(np.moveaxis(img, -1, 0), dtype=np.float32)
