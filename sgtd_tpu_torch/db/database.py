"""Sorted descriptor database with a direct-addressed bucket table
(port of the data types of sgtd_tpu.db.database).

The layout is the reference's, field for field, so a map built by either
package serves the other (``sgtd_tpu_torch.interop``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Sentinel key for padding rows: larger than any real packed key.
PAD_KEY = int(np.int32(2**31 - 1))

# Direct bucket-table rows are (start, length) words; no packing limit
# below 2^31 rows.
MAX_TABLE_ROWS = 1 << 31


class DescriptorDB(NamedTuple):
    """Sorted descriptor table + keyframe store.

    The reference stores ``packed2`` and ``bucket_table`` as uint32. Torch
    supports few operations on uint32 (no shifts on the CPU), so the port
    keeps them as the **int32 bit pattern** of the same words (NumPy
    ``.view(np.int32)``). Unpack a 16-bit half with a masked shift,
    ``(w >> 16) & 0xFFFF``: the arithmetic shift sign-extends, so the mask
    is required.

    keys:        (M,) int32 ascending (cell*2197+code); padding rows PAD_KEY.
    codes:       (M,) int32 — packed vertex-label triple (-1 for padding).
    packed2:     (M, 2) int32 bits — word 0 = sides a | b << 16, word 1 =
                 side c | frame << 16, sides in 16-bit fixed point
                 (round(side * 256)).
    vertices:    (M, 3, 3) float32 — rows A, B, C in the keyframe frame.
    frame_ids:   (M,) int32 — owning keyframe.
    cell_start:  (extent^3 + 1,) int32 — first row of each quantised cell.
    frame_rows:  (M,) int32 — row ids grouped by keyframe.
    frame_start: (F + 1,) int32 — offsets into frame_rows per keyframe.
    frame_poses: (F, 4, 4) float32 — keyframe poses (world from sensor).
    frame_valid: (F,) bool.
    bucket_table: (T, 2) int32 bits — (row_start, length) of the
                  (dense_cell, dense_code) bucket at slot
                  dense_cell * table_stride + dense_code; (0, 0) = empty.
                  Empty (T = 0) when the DB exceeds the table budget.
    cell_remap:  (extent^3,) int32 — cell -> dense cell id, -1 when unused.
    code_remap:  (2197,) int32 — label code -> dense code id, -1 when unused.
    table_stride: (1,) int32 — number of distinct label codes.
    """

    keys: torch.Tensor
    codes: torch.Tensor
    packed2: torch.Tensor
    vertices: torch.Tensor
    frame_ids: torch.Tensor
    cell_start: torch.Tensor
    frame_rows: torch.Tensor
    frame_start: torch.Tensor
    frame_poses: torch.Tensor
    frame_valid: torch.Tensor
    bucket_table: torch.Tensor
    cell_remap: torch.Tensor
    code_remap: torch.Tensor
    table_stride: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.frame_poses.shape[0]

    @property
    def has_direct_table(self) -> bool:
        return self.bucket_table.shape[0] > 0


@dataclasses.dataclass
class DBBuildReport:
    """Coverage stats — a DB build never truncates silently."""

    num_rows: int
    num_frames: int
    num_cells: int
    # Max rows sharing one (cell, code) bucket.
    max_bucket: int
    # Rows beyond ``bucket_cap`` in their bucket (-1: some exist).
    rows_beyond_cap: int
    # Max rows sharing one quantised cell.
    max_cell_bucket: int = 0

    @property
    def suggested_bucket_cap(self) -> int:
        """Smallest static bucket cap (multiple of 8) covering every bucket."""
        return max(8, -(-self.max_bucket // 8) * 8)


def tuned_config(config, report: DBBuildReport):
    """``config`` with the bucket cap fitted to this DB."""
    caps = dataclasses.replace(config.caps, bucket_cap=report.suggested_bucket_cap)
    return config.replace(caps=caps)
