"""Image I/O: PNG/TIFF/PPM/JPEG (8- and 16-bit) via PIL, plus PBM masks.

Replaces the reference's OpenCV `imread(..., CV_LOAD_IMAGE_UNCHANGED)` usage
(slow_flow.cpp:470) and libpng/libjpeg loaders (epic_flow_extended/io.c:192-403).
Images are returned as float32 arrays:
  grayscale/raw -> [H, W]
  color         -> [H, W, 3] RGB
"""
from __future__ import annotations

import numpy as np
from PIL import Image


def read_image(path) -> np.ndarray:
    """Read an image file unchanged (8/16-bit preserved) as float32.

    16-bit single channel images (the raw Bayer teasers) come back as [H, W]
    with values in 0..65535; 8-bit color as [H, W, 3] in 0..255.
    """
    img = Image.open(path)
    if img.mode == "P":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, :3]
    return arr.astype(np.float32)


def is_16bit(path) -> bool:
    """Whether the image file holds 16-bit (or wider) samples."""
    with Image.open(path) as img:
        return img.mode in ("I", "I;16", "I;16B", "I;16L", "F")


def write_image(path, arr: np.ndarray, bit16: bool = False) -> None:
    """Write an image. arr is [H, W] or [H, W, 3]; clipped to dtype range."""
    arr = np.asarray(arr)
    if bit16:
        out = np.clip(arr, 0, 65535).astype(np.uint16)
        if out.ndim == 3:
            # PIL cannot write 16-bit RGB PNG portably; fall back to per-channel
            # scale into 8-bit (only used for debug outputs).
            out = np.clip(arr / 256.0, 0, 255).astype(np.uint8)
            Image.fromarray(out, "RGB").save(path)
            return
        Image.fromarray(out).save(path)  # uint16 -> I;16 inferred
    else:
        out = np.clip(arr, 0, 255).astype(np.uint8)
        mode = "RGB" if out.ndim == 3 else "L"
        Image.fromarray(out, mode).save(path)


def read_pbm(path) -> np.ndarray:
    """Read a PBM/PGM/PNG binary mask as uint8 {0, 255} array [H, W].

    The reference stores occlusion maps as binary PBM via OpenCV
    (slow_flow.cpp:899-904) and reads them back with imread
    (dense_tracking.cpp:1169).
    """
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8) * 255
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)


def write_pbm(path, arr: np.ndarray) -> None:
    """Write a {0, 255}-valued mask as binary PBM (pixel >= 128 -> white)."""
    arr = np.asarray(arr)
    Image.fromarray(arr >= 128).save(path)
