"""Stage 2, the jet solve: the port's `variational_mt_batched` on the
route the configuration picks, fed as the stage-2 CLI feeds it.

Set-up makes the traffic's pool of jets on the device and derives what the
CLI derives from the frames with the port's own functions: each jet's
normalization (`normalize_sequence`) and the channel weights (ones, with
no Bayer decode). A call solves one batch of the pool from zero flow and
copies the flow and the labels to the host, as the CLI does before it
writes them.

`correct` compares a sample of the jets that the window solved, drawn from
the seed, with the plain reference (reference/jet_solve.py), which works
out the normalization again from the same frames.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmarks import harness
from benchmarks.reference import jet_solve as reference


class Cell:
    unit = "jets"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 bench_dir=harness.BENCH_DIR):
        from slowflow_tpu_torch.config.params import ParameterList
        from slowflow_tpu_torch.core.image import normalize_sequence
        from slowflow_tpu_torch.variational.params import MultiFrameParams

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        gen = harness.load_part(bench_dir, "generators",
                                traffic["generator"], ".py")
        self.frames = gen.make(traffic, config, seed, self.device)["frames"]
        n, _, _, h, w = self.frames.shape
        self.batch = int(traffic["batch"])
        if n % self.batch:
            raise ValueError(f"a pool of {n} jets does not split into "
                             f"batches of {self.batch}")
        self.n_batches = n // self.batch
        norm = [normalize_sequence(x) for x in self.frames.cpu().numpy()]
        self.seq = torch.as_tensor(np.stack([s for s, _, _ in norm]),
                                   device=self.device)
        self.avg = torch.as_tensor(np.stack([a for _, a, _ in norm]),
                                   dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(np.stack([s for _, _, s in norm]),
                                   dtype=torch.float32, device=self.device)
        self.cw = torch.ones((self.batch, 3, h, w), device=self.device)
        self.zero = torch.zeros((self.batch, h, w), device=self.device)
        params = ParameterList()
        for key, value in config["cfg"].items():
            params.insert(key, str(value), overwrite=True)
        self.p = MultiFrameParams.from_parameter_list(params)

    def units(self, i: int) -> int:
        return self.batch

    def entries(self, i: int) -> range:
        """The jets of the pool that call i solves."""
        k = i % self.n_batches
        return range(k * self.batch, (k + 1) * self.batch)

    def call(self, i: int):
        from slowflow_tpu_torch.variational.multiframe import \
            variational_mt_batched

        jets = self.entries(i)
        s = slice(jets.start, jets.stop)
        wx, wy, occ = variational_mt_batched(
            self.zero, self.zero, self.seq[s], self.p, self.cw, self.avg[s],
            self.std[s], device=self.device)
        return wx.cpu().numpy(), wy.cpu().numpy(), occ.cpu().numpy()

    def warm(self):
        """One call: every level's graphs are captured on it."""
        self.call(0)

    @contextlib.contextmanager
    def tracing(self):
        """Counters of the traced calls: the launches of each kernel
        wrapper, graph replays included (the port's `kernels.LAUNCHES`)."""
        from slowflow_tpu_torch import kernels

        counts = dict(launches={})
        before = dict(kernels.LAUNCHES)
        yield counts
        counts["launches"] = {k: kernels.LAUNCHES[k] - before[k]
                              for k in before}

    def release(self):
        """Drop the program's graphs and inputs once the window closed."""
        from slowflow_tpu_torch.variational import graphs

        if self.device.type == "cuda":
            graphs.clear()
        self.seq = self.avg = self.std = self.cw = self.zero = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, jets, dtype=torch.float32):
        """The reference's (wx, wy, occ) [K, H, W] of these jets of the
        pool, in `dtype` (float32 the reference, a lower precision the
        control)."""
        pool = torch.tensor(list(jets), device=self.device)
        want = reference.solve_jets(self.frames[pool], self.config["cfg"],
                                    dtype)
        return [x.cpu().numpy() for x in want]


def compare(got, want, limits: dict) -> list[dict]:
    """got, want: (wx, wy, occ) [K, H, W] of the same jets. The mean
    end-point error of the flow and the share of labels that differ."""
    epe = np.hypot(got[0] - want[0], got[1] - want[1])
    values = dict(flow_epe_mean_px=float(epe.mean()),
                  occ_mismatch_share=float((got[2] != want[2]).mean()))
    return [dict(name=k, value=v, limit=limits[k]) for k, v in values.items()]
