"""The port held to the reference binary's own output and to the committed
goldens, on the CPU.

- `slowflow_tpu_torch.cli.epicflow ... -sintel -device cpu` (LA, and NW with
  `-nw`) on tests/parity/'s fixture: mean EPE < 0.1 px against the C++
  `epicflow` binary's `ref_la_sintel.flo` / `ref_nw_sintel.flo`, the bound
  tests/test_parity_reference.py holds the JAX CLI to.
- tests/golden/goldens.npz, on tests/golden/make_goldens.py's inputs, at
  tests/test_golden.py's tolerances: `accumulate_flow` within 1e-5; the
  distance transform's distances within 1e-4 and < 1 % of its labels
  different; `epic` within 1e-3 px on all but < 1 % of pixels.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from slowflow_tpu_torch.cli.epicflow import main as epicflow_main
from slowflow_tpu_torch.core.image import rgb_to_lab
from slowflow_tpu_torch.epic import EpicParams, epic
from slowflow_tpu_torch.epic.distance import distance_transform
from slowflow_tpu_torch.io import read_flo
from slowflow_tpu_torch.tracking.accumulate import accumulate_flow
from test_torch_tracking import one_torch_thread  # noqa: F401

HERE = Path(__file__).resolve().parent
PARITY = HERE / "parity"


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(HERE / "golden" / "goldens.npz"))


@pytest.mark.parametrize("golden, extra", [
    ("ref_la_sintel.flo", ["-sintel"]),
    ("ref_nw_sintel.flo", ["-nw", "-sintel"]),
], ids=["LA", "NW"])
def test_epicflow_cli_matches_the_reference_binary(tmp_path, golden, extra):
    out = tmp_path / "port.flo"
    assert epicflow_main([str(PARITY / "im1.png"), str(PARITY / "im2.png"),
                          str(PARITY / "edges.dat"),
                          str(PARITY / "matches.txt"), str(out)]
                         + extra + ["-device", "cpu"]) == 0
    ours, ref = read_flo(out), read_flo(PARITY / golden)
    epe = float(np.hypot(ours[..., 0] - ref[..., 0],
                         ours[..., 1] - ref[..., 1]).mean())
    assert epe < 0.1, f"mean EPE vs reference binary = {epe:.4f} px"


def test_accumulate_golden(gold):
    rng = np.random.default_rng(7)     # make_goldens.golden_accumulate
    h, w, n = 24, 28, 4
    flows = (rng.normal(size=(n, h, w, 2)).astype(np.float32) * 0.2
             + np.array([1.0, 0.5], np.float32))
    occ = np.zeros((n, h, w), np.uint8)
    occ[2, 4:8, 4:8] = 1
    got = accumulate_flow(flows, occ, device="cpu").numpy()
    np.testing.assert_allclose(got, gold["acc_flow"], rtol=0, atol=1e-5)


def test_distance_transform_golden(gold):
    rng = np.random.default_rng(4)     # make_goldens.golden_distance_transform
    h, w = 40, 44
    cost = rng.random((h, w)).astype(np.float32) + 0.05
    seed_dist = np.full((h, w), 1e9, np.float32)
    seed_labels = np.full((h, w), -1, np.int32)
    idx = 0
    for y in range(0, h, 9):
        for x in range(0, w, 11):
            seed_dist[y, x] = cost[y, x]
            seed_labels[y, x] = idx
            idx += 1
    dist, labels = distance_transform(torch.as_tensor(cost),
                                      torch.as_tensor(seed_dist),
                                      torch.as_tensor(seed_labels))
    np.testing.assert_allclose(dist.numpy(), gold["dt_dist"], rtol=0,
                               atol=1e-4)
    assert (labels.numpy() != gold["dt_labels"]).mean() < 0.01


def test_epic_golden(gold):
    rng = np.random.default_rng(5)               # make_goldens.golden_epic
    h, w = 48, 56
    img = np.zeros((3, h, w), np.float32)
    img[0] = np.linspace(0, 255, w)[None, :]
    img[1] = np.linspace(0, 255, h)[:, None]
    img[2] = 128.0
    imlab = rgb_to_lab(torch.as_tensor(img))
    edges = np.zeros((h, w), np.float32)
    edges[:, w // 2] = 1.0
    n = 60
    mx = rng.integers(2, w - 2, n).astype(np.float32)
    my = rng.integers(2, h - 2, n).astype(np.float32)
    u = np.where(mx < w // 2, 2.0, -1.0).astype(np.float32)
    v = np.where(mx < w // 2, 0.5, 1.0).astype(np.float32)
    matches = np.stack([mx, my, mx + u, my + v], 1)
    flow = epic(imlab, matches, edges,
                EpicParams(pref_nn=10, nn=20, coef_kernel=0.8), device="cpu")
    diff = np.abs(flow - gold["epic_flow"]).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01, (diff > 1e-3).mean()
    np.testing.assert_allclose(flow[diff <= 1e-3],
                               gold["epic_flow"][diff <= 1e-3],
                               rtol=0, atol=1e-3)

