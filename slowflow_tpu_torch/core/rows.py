"""Where strip windows lie in their image: the row arithmetic that the
kernels, their twins and the level solve share with the strip plan
(parallel/strips.py builds the tables)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class StripRows(NamedTuple):
    """Where the windows of a [E, ..., H_win, W] batch lie in their image:
    `table` int32 [E, 3] on the windows' device holds each window's first
    image row and its own rows [lo, hi) in window rows; `img_h` is the
    image's height."""

    table: torch.Tensor
    img_h: int


def row_offsets(rows: StripRows) -> torch.Tensor:
    """Each window's first image row, int64 [E, 1, 1]."""
    return rows.table[:, 0].long().view(-1, 1, 1)


def own_rows(rows: StripRows, h: int) -> torch.Tensor:
    """True on each window's own rows, bool [E, h, 1]."""
    r = torch.arange(h, device=rows.table.device).view(1, h, 1)
    lo = rows.table[:, 1].long().view(-1, 1, 1)
    hi = rows.table[:, 2].long().view(-1, 1, 1)
    return (r >= lo) & (r < hi)


def red_cells(rows: StripRows | None, h: int, w: int, device):
    """True where (image row + column) is even: [h, w], or [E, h, w] with
    `rows`."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    if rows is None:
        return (yy + xx) % 2 == 0
    return (row_offsets(rows) + yy + xx) % 2 == 0
