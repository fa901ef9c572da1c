"""Stage 3, dense tracking: the port's `track_final_pairs_batched`, one
final pair a call (the stage-3 CLI's default `batch_finals` 1), fed as the
CLI feeds it.

Set-up makes the traffic's pool of final pairs on the device (frames, jet
flows, the propagation's draws) and derives what the CLI derives from them
with the port's own functions: the normalization, the derivatives, the
smoothness weight and EPIC's context (Lab image and edges of the reference
frame at the tracking grid's scale). The jet flows and the per-final data
are handed over as host arrays, as the CLI reads them from disk.

`correct` compares a sample of the final pairs that the window tracked,
drawn from the seed, with the plain reference (reference/stage3/), which
works out those derivations again from the same frames and flows.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmarks import harness
from benchmarks.reference import stage3 as reference


# px: a final pixel whose flow is off by more than this counts as a mismatch
MISMATCH_PX = 0.01


class Cell:
    unit = "finals"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 bench_dir=harness.BENCH_DIR):
        from slowflow_tpu_torch.config.params import ParameterList
        from slowflow_tpu_torch.tracking.driver import TrackingConfig

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        gen = harness.load_part(bench_dir, "generators",
                                traffic["generator"], ".py")
        scene = gen.make(traffic, config, seed, self.device)
        self.frames, self.draws = scene["frames"], scene["draws"]
        self.forward, self.backward = scene["forward"], scene["backward"]
        params = ParameterList()
        for key, value in config["cfg"].items():
            params.insert(key, str(value), overwrite=True)
        self.cfg = TrackingConfig.from_parameter_list(
            params, int(config["cfg"]["Jets"]), 1)
        self.jobs = [self._job(k) for k in range(len(self.frames))]

    def _job(self, k: int) -> dict:
        """The CLI's per-final inputs of pool entry k."""
        from slowflow_tpu_torch.cli.dense_tracking import smoothness_weight
        from slowflow_tpu_torch.core.conv import (DERIV_5PT, conv_horiz,
                                                  conv_vert)
        from slowflow_tpu_torch.core.image import (normalize_sequence,
                                                   resize_bilinear,
                                                   rgb_to_lab)
        from slowflow_tpu_torch.epic import EpicParams
        from slowflow_tpu_torch.epic.edges import detect_edges

        cfg = self.config["cfg"]
        hbit = bool(int(cfg["16bit"]))
        data = self.frames[k].cpu().numpy()
        stack, avg, std = normalize_sequence(data)
        oh, ow = stack.shape[2:]
        st = torch.as_tensor(stack, device=self.device)
        dx = conv_horiz(st, DERIV_5PT).permute(0, 2, 3, 1).cpu().numpy()
        dy = conv_vert(st, DERIV_5PT).permute(0, 2, 3, 1).cpu().numpy()
        sw = smoothness_weight(stack[0], avg, std, hbit, self.device)
        ref8 = torch.as_tensor(np.clip(data[0] / 255.0, 0, 255) if hbit
                               else data[0], device=self.device)
        if self.cfg.skip_pixel:
            scale = 1.0 / (self.cfg.skip_pixel + 1)
            ref8 = resize_bilinear(ref8, int(oh * scale), int(ow * scale))
        epic_ctx = (rgb_to_lab(ref8).cpu().numpy(),
                    detect_edges(ref8).cpu().numpy(), EpicParams.sintel())
        fwd = self.forward[k].cpu().numpy()
        bwd = self.backward[k].cpu().numpy()
        return dict(rate_flows=[(fwd, bwd, None)], forward=fwd, backward=bwd,
                    occlusions=None, data=np.moveaxis(stack, 1, -1),
                    data_dx=dx, data_dy=dy, smooth_weight=sw,
                    epic_ctx=epic_ctx)

    def units(self, i: int) -> int:
        return 1

    def entries(self, i: int) -> list[int]:
        """The final pair of the pool that call i tracks."""
        return [i % len(self.frames)]

    def call(self, i: int):
        from slowflow_tpu_torch.tracking.driver import \
            track_final_pairs_batched

        k = self.entries(i)[0]
        draws = self.draws[k]

        def draw(p_it, t, ntry, h, w):
            return draws[(p_it, t)]

        flows, occs, _ = track_final_pairs_batched(
            self.cfg, [self.jobs[k]], device=self.device, draws=draw)
        return np.stack(flows), np.stack(occs)

    def warm(self):
        """One call: the alternation's and the solve's graphs are captured
        on it, and the distance transforms' of its shapes."""
        self.call(0)

    @contextlib.contextmanager
    def tracing(self):
        """Spans of the traced calls: the port's phase timers
        (`dt.init_final`, `dt.epic_hypotheses`, `epic.*`)."""
        from slowflow_tpu_torch.utils import phases

        with phases.recording() as rec:
            counts = dict(phases=rec)
            yield counts
        counts["phases"] = dict(rec)

    def release(self):
        """Drop the program's graphs and inputs once the window closed."""
        from slowflow_tpu_torch.variational import graphs

        if self.device.type == "cuda":
            graphs.clear()
            graphs.clear_shared()
        self.jobs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, finals, dtype=torch.float32):
        """The reference's (flows [K, h, w, 2], occlusion maps [K, h, w])
        of these finals of the pool, in `dtype` (float32 the reference, a
        lower precision the control)."""
        outs = [reference.final_pair(self.frames[k], self.forward[k],
                                     self.backward[k], self.draws[k],
                                     self.config["cfg"], self.device, dtype)
                for k in finals]
        return [np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])]


def compare(got, want, limits: dict) -> list[dict]:
    """got, want: (flows [K, h, w, 2], occlusion maps [K, h, w]) of the same
    finals. The mean end-point error of the final flow, and the share of
    pixels whose flow is off by more than MISMATCH_PX or whose occlusion
    flag differs (the flags hold still under rounding: they are set by
    thresholds of 5 px)."""
    epe = np.hypot(*(got[0] - want[0]).transpose(3, 0, 1, 2))
    off = (epe > MISMATCH_PX) | (got[1] != want[1])
    values = dict(final_epe_mean_px=float(epe.mean()),
                  final_pixel_mismatch_share=float(off.mean()))
    return [dict(name=k, value=v, limit=limits[k]) for k, v in values.items()]
