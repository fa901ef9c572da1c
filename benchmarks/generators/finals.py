"""Final pairs of the two-layer scene, made on the device from a seed.

Each final pair has Jets + 1 frames of a scene of its own (the jets'
scene: a background translating (u, v) px a frame, a disc of another
texture moving (-u, v)), the Jets jet flows of that motion with N(0, 0.08)
noise, the disc's flow taken where the disc is in the middle frame (as the
repo's stage-3 bench pair, `stage3_final_pair`, takes it), the backward
flows their negation, and the
random draws of stage 3's propagation. Every seed gives the same set of
speeds and directions, in another order.
"""
from __future__ import annotations

import math

import torch

from benchmarks import harness


def make(traffic: dict, config: dict, seed: int, device) -> dict:
    """frames [N, J+1, 3, H, W] float32 in 0..255, forward / backward
    [N, J, H, W, 2] float32, and draws[n][(p_it, t)] = (ang, u), each
    [tryouts, H / (skip + 1), W / (skip + 1)]."""
    cfg = config["cfg"]
    n, jets = int(traffic["pool_finals"]), int(cfg["Jets"])
    h, w = int(config["height"]), int(config["width"])
    jets_gen = harness.import_file(harness.BENCH_DIR / "generators"
                                   / "jets.py")
    scene = jets_gen.make(dict(pool_jets=n, speed_px=traffic["speed_px"]),
                          dict(cfg={"slow_flow_S": jets // 2 + 1},
                               height=h, width=w), seed, device)
    frames = scene["frames"]
    u, v = scene["u"], scene["v"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
    fwd = torch.empty((n, jets, h, w, 2), device=device)
    fwd[..., 0] = torch.where(fg, -u[:, None, None, None],
                              u[:, None, None, None])
    fwd[..., 1] = v[:, None, None, None]
    fwd += 0.08 * torch.randn(fwd.shape, generator=gen, device=device)
    skip = int(cfg["acc_skip_pixel"]) + 1
    ntry = int(cfg["acc_hyp_neigh_tryouts"])
    shape = (ntry, h // skip, w // skip)
    draws = [{(p, t): (2 * math.pi * torch.rand(shape, generator=gen,
                                                device=device),
                       torch.rand(shape, generator=gen, device=device))
              for p in range(int(cfg["acc_alternate"])) for t in range(2)}
             for _ in range(n)]
    return dict(frames=frames.contiguous(), forward=fwd, backward=-fwd,
                draws=draws)
