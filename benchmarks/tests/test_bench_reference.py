"""The stage-3 reference's per-pixel steps over the whole bank (the
energies of a propagation pass, NMS, the pairwise costs) run over blocks
of grid rows; on the CPU at a small size, with several blocks, each gives
the whole grid's values bit for bit, and so does a whole final pair."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks import harness
from benchmarks.reference import stage3 as reference
from benchmarks.reference.stage3 import driver, mrf, support
from benchmarks.reference.stage3.hypothesis import UNKNOWN

BENCH = Path(__file__).resolve().parents[1]
WHOLE = 1 << 62          # every step in one block


def bank_and_fields(seed: int, h=11, w=9, K=5, J=4, skip=1):
    """A bank [1, h, w, K, ...] with unknown and invalid slots, and the
    energy fields at the full resolution, drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    H, W = h * (skip + 1), w * (skip + 1)
    flows = 3 * torch.randn((1, h, w, K, J, 2), generator=g)
    flows[torch.rand((1, h, w, K), generator=g) < 0.2] = UNKNOWN
    bank = dict(flows=flows,
                occl=torch.randint(0, 2, (1, h, w, K, J + 1), generator=g,
                                   dtype=torch.int32),
                energy=torch.rand((1, h, w, K), generator=g),
                valid=torch.rand((1, h, w, K), generator=g) < 0.8,
                jet_est=torch.zeros((1, h, w, K), dtype=torch.int32))
    fwd = 2 * torch.randn((1, J, H, W, 2), generator=g)
    fields = dict(forward=fwd, backward=-fwd,
                  data=torch.rand((1, J + 1, H, W, 3), generator=g),
                  data_dx=torch.randn((1, J + 1, H, W, 3), generator=g),
                  data_dy=torch.randn((1, J + 1, H, W, 3), generator=g),
                  occ_masks=None,
                  smooth_weight=torch.rand((1, H, W), generator=g))
    return bank, fields


def step(name: str, bank, fields, cfg):
    if name == "nms":
        out = driver._bank_nms(bank, cfg.traj_sim_method, cfg.traj_sim_thres)
        return [out["valid"], out["energy"]]
    if name == "pairwise":
        return list(mrf.pairwise_costs(
            bank["flows"], bank["occl"], fields["smooth_weight"],
            cfg.acc_beta, cfg.acc_spatial_occ, cfg.traj_sim_method,
            cfg.skip_pixel + 1, int(0.5 * cfg.skip_pixel)))
    ins = SimpleNamespace(fields=fields, weight_jet=torch.zeros(1))
    st = SimpleNamespace(bank=bank, valid0=bank["valid"]
                         & (torch.arange(bank["valid"].shape[-1]) < 2))
    driver._Alternation(cfg, ins, st).energies()
    return [st.bank["occl"], st.bank["energy"]]


@pytest.mark.parametrize("name,per_row", [
    ("nms", 9 * 5 * 5 * 4 * 2), ("pairwise", 9 * 5 * 5 * 4 * 2),
    ("energies", 9 * 5 * 5 * 4 // 2 * 9)])
def test_a_step_over_row_blocks_is_the_whole_grids(name, per_row,
                                                   monkeypatch):
    cfg = driver.TrackingConfig(jets=4, rates=1, capacity=5)
    monkeypatch.setattr(support, "BLOCK_ELEMENTS", WHOLE)
    assert len(support.row_blocks(11, per_row)) == 1
    whole = step(name, *bank_and_fields(7), cfg)
    # 3 rows a block: blocks of 3, 3, 3 and 2 rows
    monkeypatch.setattr(support, "BLOCK_ELEMENTS", 3 * per_row + 1)
    assert [s.stop - s.start for s in support.row_blocks(11, per_row)] \
        == [3, 3, 3, 2]
    blocked = step(name, *bank_and_fields(7), cfg)
    for a, b in zip(whole, blocked):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_final_pair_over_row_blocks_is_the_whole_grids(monkeypatch):
    config = json.loads((BENCH / "configs" / "tracking_1080q.json")
                        .read_text())
    config.update(height=40, width=56)
    config["cfg"].update(Jets="4", acc_alternate="2",
                         acc_hyp_neigh_tryouts="8", acc_capacity="8")
    traffic = json.loads((BENCH / "traffic" / "finals.f1.json").read_text())
    traffic.update(pool_finals=1)
    make = harness.import_file(BENCH / "generators" / "finals.py").make
    scene = make(traffic, config, 2 ** 31 + 11, "cpu")

    def final():
        return reference.final_pair(scene["frames"][0], scene["forward"][0],
                                    scene["backward"][0], scene["draws"][0],
                                    config["cfg"], "cpu")

    monkeypatch.setattr(support, "BLOCK_ELEMENTS", WHOLE)
    whole = final()
    # the tracking grid is 20 x 28: the largest step then takes 4 rows
    monkeypatch.setattr(support, "BLOCK_ELEMENTS", 28 * 8 * 5 * 4 // 2 * 9 * 4)
    assert len(support.row_blocks(20, 28 * 8 * 8 * 4 * 2)) > 1
    blocked = final()
    for a, b in zip(whole, blocked):
        assert np.array_equal(a, b)


def graph(seed: int, ns: int = 60, edges: int = 110):
    """An undirected CSR graph as `distance.seed_graph` makes one: each
    pair once each way, rows sorted; weights of a few values, so that
    paths tie, and nodes left out of every edge."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, ns - 6, edges)
    b = rng.integers(0, ns - 6, edges)
    keep = a != b
    pairs = np.unique(np.sort(np.stack([a[keep], b[keep]], 1), 1), axis=0)
    w = rng.integers(1, 4, len(pairs)).astype(np.float32) * 0.5
    rows = np.concatenate([pairs[:, 0], pairs[:, 1]])
    cols = np.concatenate([pairs[:, 1], pairs[:, 0]])
    vals = np.concatenate([w, w])
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(ns + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols[order].astype(np.int32), vals[order]


def knn_by_heap(indptr, indices, data, k: int):
    """One Dijkstra a source with a heap of (distance, node): float32 sums,
    the lowest node first on a tie, the first k nodes settled."""
    import heapq

    ns = len(indptr) - 1
    best = np.full((ns, k), -1, np.int32)
    dist = np.full((ns, k), np.inf, np.float32)
    for s in range(ns):
        tent, done, heap, n = {s: np.float32(0)}, set(), [(0.0, s)], 0
        while heap and n < k:
            du, u = heapq.heappop(heap)
            if u in done or du != tent[u]:
                continue
            done.add(u)
            best[s, n], dist[s, n] = u, du
            n += 1
            for e in range(indptr[u], indptr[u + 1]):
                v, nd = int(indices[e]), np.float32(tent[u] + data[e])
                if v not in tent or nd < tent[v]:
                    tent[v] = nd
                    heapq.heappush(heap, (nd, v))
    return best, dist


@pytest.mark.parametrize("seed,k,block", [(1, 7, 1 << 28), (2, 7, 1 << 28),
                                          (3, 12, 1 << 28), (4, 7, 200)])
def test_knn_shortest_paths_is_dijkstra_from_each_source(seed, k, block,
                                                         monkeypatch):
    """Against one heap Dijkstra a source, exactly, ties and nodes that
    reach fewer than k others included; block 200 splits the sources into
    chunks of a few."""
    monkeypatch.setattr(support, "BLOCK_ELEMENTS", block)
    g = graph(seed)
    best, dist = support.knn_shortest_paths(*g, k, "cpu")
    want_best, want_dist = knn_by_heap(*g, k)
    assert (want_best[:, -1] == -1).any() and (want_best[:, -1] >= 0).any()
    assert np.array_equal(best, want_best)
    assert np.array_equal(dist, want_dist)
