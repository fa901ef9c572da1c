"""Jets of the two-layer scene, made on the device from a seed.

Each jet is a window of 2S - 1 frames of a scene of its own: a smooth
random colour background translating (u, v) px a frame and a disc of
another texture moving (-u, v), so the occlusion reasoning has real
boundaries (the scene of the repo's bench, `moving_sequence`, here in
torch on the device). Each colour channel is a texture of its own, so the
channels, and Lab's a and b, differ as in colour footage. Every seed gives
the same set of speeds and directions, evenly spread over the mix's range,
in another order; the seed also draws the textures.
"""
from __future__ import annotations

import math

import torch

def _smooth(t):
    for _ in range(2):
        t = 0.25 * (torch.roll(t, 1, -2) + torch.roll(t, -1, -2)
                    + torch.roll(t, 1, -1) + torch.roll(t, -1, -1))
    return t


def _sample(tex, dx, dy, h: int, w: int, pad: int):
    """Bilinear samples of tex [J, C, H2, W2] at (x + pad - dx,
    y + pad - dy), dx / dy [J]; coordinates clamped into the texture."""
    h2, w2 = tex.shape[-2:]
    dev = tex.device
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = (xx + pad - dx[:, None, None]).clamp(0, w2 - 2)
    ys = (yy + pad - dy[:, None, None]).clamp(0, h2 - 2)
    x0, y0 = xs.floor(), ys.floor()
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    fx, fy = fx[:, None], fy[:, None]
    flat = tex.flatten(2)
    c = flat.shape[1]

    def at(yi, xi):
        idx = (yi * w2 + xi).flatten(1)[:, None].expand(-1, c, -1)
        return flat.gather(2, idx).view(-1, c, h, w)

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


def make(traffic: dict, config: dict, seed: int, device) -> dict:
    """frames [J, 2S-1, 3, H, W] float32 in 0..255 and each jet's (u, v)."""
    n = int(traffic["pool_jets"])
    f = 2 * int(config["cfg"]["slow_flow_S"]) - 1
    h, w = int(config["height"]), int(config["width"])
    lo, hi = traffic["speed_px"]
    ref = (f - 1) // 2
    pad = int(math.ceil(hi * ref)) + 2   # past the largest offset, px
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tex = _smooth(torch.rand((n, 2, 3, h + 2 * pad, w + 2 * pad),
                             generator=gen, device=device) * 255)
    q = (torch.arange(n, device=device, dtype=torch.float32) + 0.5) / n
    speed = lo + (hi - lo) * q[torch.randperm(n, generator=gen,
                                              device=device)]
    angle = 2 * math.pi * q[torch.randperm(n, generator=gen, device=device)]
    u, v = speed * torch.cos(angle), speed * torch.sin(angle)

    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    frames = []
    for s in range(-ref, f - ref):
        bg = _sample(tex[:, 0], s * u, s * v, h, w, pad)
        fg = _sample(tex[:, 1], -s * u, s * v, h, w, pad)
        in_fg = ((yy - (cy + s * v[:, None, None])) ** 2
                 + (xx - (cx - s * u[:, None, None])) ** 2) < r * r
        frames.append(torch.where(in_fg[:, None], fg, bg))
    return dict(frames=torch.stack(frames, 1).contiguous(), u=u, v=v)
