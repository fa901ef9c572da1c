"""K1 / K5's plan (csrc/solve_step.cu `make_plan`) through its Python
mirror `fused_solve.plan_model`, on an H100 SXM's 132 SMs and 227 KB
(232,448 bytes) of opt-in shared memory a block: the regime each shape
takes (resident, grouped, row-streamed), its groups, and over a grid of
shapes that every jet lies in exactly one group, that groups differ by at
most one jet, and that each group's bands fit one block per SM. Runs on the
CPU; tests/test_torch_kernels_cuda.py holds the card's own plan to the
mirror.

    python -m pytest tests/test_torch_solve_plan.py -q
"""
from __future__ import annotations

import pytest

from slowflow_tpu_torch.variational import fused_solve

H100 = dict(nsm=132, optin=232_448)


def _plan(*shape):
    return fused_solve.plan_model(*shape, **H100)


@pytest.mark.parametrize("shape, regime, group, groups", [
    ((4, 270, 480), "resident", 4, 1),        # the bench shape
    ((8, 270, 480), "grouped", 4, 2),         # 4 + 4, not 5 + 3
    ((16, 270, 480), "grouped", 4, 4),
    ((40, 270, 480), "grouped", 5, 8),        # stage 1's K5
    ((4, 540, 960), "grouped", 1, 4),         # scale 0.5: a jet a group
    ((1, 1080, 1920), "row-streamed", 1, 1),  # 1080p, one jet
    ((2, 1207, 3840), "row-streamed", 2, 1),  # the sp path's 2160p windows
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_plan_regime_and_groups(shape, regime, group, groups):
    plan = _plan(*shape)
    assert (plan.regime, plan.group, plan.groups) == (regime, group, groups)
    assert plan.resident == (regime == "resident")


def test_bench_shape_keeps_its_resident_plan():
    """4 x 270 x 480: 33 bands of at most 9 rows a jet on 132 blocks of
    512 threads, as before the grouped and row-streamed paths."""
    plan = _plan(4, 270, 480)
    assert (plan.grid, plan.nbands, plan.bands_per_jet, plan.rows,
            plan.smem_bytes, plan.scratch_floats, plan.threads) == (
        132, 132, 33, 9, 165_120, 507_144, 512)


def test_row_streamed_chunks_cover_the_row():
    for shape, chunks in (((1, 1080, 1920), 1), ((1, 2160, 3840), 2),
                          ((2, 1207, 3840), 2), ((2, 1081, 1921), 2)):
        plan = _plan(*shape)
        hwp = (shape[2] + 1) // 2
        assert plan.chunks == chunks
        assert plan.chunk <= fused_solve.CHUNK and plan.chunk % 4 == 0
        assert (plan.chunks - 1) * plan.chunk < hwp <= plan.chunks * plan.chunk


SHAPES = [(b, h, w) for b in (1, 2, 3, 4, 5, 7, 8, 9, 10, 16, 40, 131, 133,
                              300)
          for h, w in ((270, 480), (271, 479), (176, 314), (540, 960),
                       (1080, 1920), (2160, 3840), (1207, 3840), (9, 1),
                       (1, 33), (45, 70), (20_000, 480))]


@pytest.mark.parametrize("h, w", sorted({s[1:] for s in SHAPES}),
                         ids=lambda v: str(v))
def test_plan_invariants_over_shapes(h, w):
    limit = H100["optin"] - fused_solve.STATIC_SMEM
    for b in sorted({s[0] for s in SHAPES}):
        plan = _plan(b, h, w)
        groups = fused_solve.plan_groups(plan, b)
        jets = [j for g in groups for j in g]
        assert jets == list(range(b)), (b, h, w)     # each jet in one group
        sizes = [len(g) for g in groups]
        assert max(sizes) - min(sizes) <= 1 and max(sizes) == plan.group
        assert plan.nbands == b * plan.bands_per_jet
        assert plan.bands_per_jet * plan.rows >= h
        assert plan.smem_bytes <= limit
        assert plan.grid <= H100["nsm"]
        if plan.regime == "row-streamed":
            assert plan.groups == 1 and plan.chunks >= 1
            # not even one jet's bands fit on chip; the ring's rows are
            # padded to whole 16-byte copies
            rows = -(-h // min(h, H100["nsm"]))
            assert fused_solve.region_floats(rows, (w + 1) // 2) * 4 > limit
            hwp = -(-((w + 1) // 2) // 4) * 4
            assert plan.scratch_floats == plan.nbands * (
                16 * hwp + 2 + fused_solve.region_floats(plan.rows, hwp))
        else:
            assert plan.grid == plan.group * plan.bands_per_jet
            assert (plan.groups == 1) == (plan.regime == "resident")
            assert plan.smem_bytes == 4 * fused_solve.region_floats(
                plan.rows, (w + 1) // 2)
            # one group fewer would need more jets a group than fit
            if plan.groups > 1:
                fewer = -(-b // (plan.groups - 1))
                assert _plan(fewer, h, w).regime != "resident"


@pytest.mark.parametrize("shape, group_ms, hbm_ms", [
    ((40, 270, 480), 8 * 60 * 1.16e-3, None),        # stage 1's K5, grouped
    ((4, 270, 480), 60 * 1.16e-3, None),              # resident
    ((1, 1080, 1920), 60 * 1.16e-3,
     44 * 1080 * 1920 * 30 / 3.35e12 * 1e3),         # row-streamed: 0.817
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_solve_floors(shape, group_ms, hbm_ms):
    floors = fused_solve.solve_floors(_plan(*shape), *shape, 30)
    assert floors["group_floor_ms"] == pytest.approx(group_ms, rel=1e-12)
    if hbm_ms is None:
        assert floors["hbm_floor_ms"] is None
    else:
        assert floors["hbm_floor_ms"] == pytest.approx(hbm_ms, rel=1e-12)
