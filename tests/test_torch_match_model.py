"""The arithmetic of the grid matcher kernel's sentinel path, on the CPU.

csrc/grid_match.cu stages the search window with -1e3 outside the image
and fixes the patch bounds per point, so a tap is |a - v| with no test;
tests/match_model.py models that path (`point_costs_padded`) beside the
definition (`point_costs`: a tap displaced out reads 0 and adds 1e3).

- For planes >= 0 the two give bitwise the same float32 costs: grid
  points, the four corners, border rows and columns, radii 0, 2, 6 and 32
  (wider than the image), patch radii 0, 2 and 4, on 8-bit luminance and
  on uniform planes; hence the same labels.
- The scalar identity behind it: float32 |a + 1e3| == |a - 0| + 1e3 for
  every a >= 0 (hypothesis), and a negative a where it fails, which is
  why the kernel keeps a general tap loop for patches holding one.
"""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import match_model

H, W = 21, 30


def _planes(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "lum8":
        # luminance of 8-bit RGB frames, as the CLIs pass it
        rgb = rng.integers(0, 256, (2, 3, H, W)).astype(np.float32)
        g = (np.float32(0.299) * rgb[:, 0] + np.float32(0.587) * rgb[:, 1]
             + np.float32(0.114) * rgb[:, 2])
    else:
        g = rng.random((2, H, W)).astype(np.float32)
    return g[0], g[1]


def _points():
    """The grid of step 6, the four corners, and points on each border
    row and column."""
    gy, gx = np.mgrid[3:H:6, 3:W:6]
    pts = list(zip(gy.ravel(), gx.ravel()))
    pts += [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)]
    pts += [(0, 13), (H - 1, 7), (9, 0), (12, W - 1), (1, 2), (H - 2, W - 3)]
    return pts


@pytest.mark.parametrize("kind", ["lum8", "unit"])
@pytest.mark.parametrize("patch_r", [0, 2, 4])
@pytest.mark.parametrize("radius", [0, 2, 6, 32])
def test_padded_costs_bitwise_equal(radius, patch_r, kind):
    g1, g2 = _planes(kind, radius * 7 + patch_r)
    assert (g1 >= 0).all() and (g2 >= 0).all()
    for y, x in _points():
        want = match_model.point_costs(g1, g2, int(y), int(x), radius,
                                       patch_r)
        got = match_model.point_costs_padded(g1, g2, int(y), int(x), radius,
                                             patch_r)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), f"({y}, {x})")


def test_padded_costs_differ_for_a_negative_patch():
    """A patch value < 0 breaks the identity: the costs of displacements
    that reach outside the image differ, so such a point needs the general
    tap loop."""
    g1, g2 = _planes("unit", 3)
    g1 = g1 - np.float32(2.0)
    want = match_model.point_costs(g1, g2, 0, 0, 6, 2)
    got = match_model.point_costs_padded(g1, g2, 0, 0, 6, 2)
    assert (got != want).any()


@settings(max_examples=500, deadline=None, database=None)
@given(st.floats(min_value=0.0, allow_nan=False, width=32))
def test_sentinel_identity_for_nonnegative_values(a):
    a = np.float32(a)
    padded = np.abs(a - match_model.SENTINEL)
    defined = np.abs(a - np.float32(0)) + match_model.OUTSIDE
    assert padded.dtype == defined.dtype == np.float32
    assert padded.tobytes() == defined.tobytes()


def test_sentinel_identity_fails_below_zero():
    a = np.float32(-1.0)
    assert np.abs(a - match_model.SENTINEL) == np.float32(999.0)
    assert np.abs(a - np.float32(0)) + match_model.OUTSIDE == np.float32(
        1001.0)
