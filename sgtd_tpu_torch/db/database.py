"""Sorted descriptor database with a direct-addressed bucket table
(port of sgtd_tpu.db.database): the types, the host build and the file
format.

The layout is the reference's, field for field, so a map built by either
package serves the other (``sgtd_tpu_torch.interop``). The host build
(``build_database``) runs in NumPy, as the reference's does, and gives the
same fields as ``db.device_build`` on the same descriptors; the on-device
build is the one the entry points use. ``save_database`` writes the
reference's ``.npz`` (format v2, ``packed2`` and ``bucket_table`` as
uint32), so a DB saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from sgtd_tpu_torch.config import CapacityConfig, DescriptorConfig
from sgtd_tpu_torch.desc.keys import _N_CODES, validate_key_space
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.utils import host_array as _host

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


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def build_database(
    desc_list: Sequence[Descriptors],
    poses: Sequence,
    cfg: DescriptorConfig = DescriptorConfig(),
    caps: CapacityConfig = CapacityConfig(),
    device: torch.device | str = "cuda",
) -> Tuple[DescriptorDB, DBBuildReport]:
    """The sorted DB of per-keyframe descriptor sets, built on the host.

    ``desc_list[i]``: keyframe ``i``'s descriptors (each field with a
    leading axis of 1, or none); ``poses[i]``: its 4x4 world-from-sensor
    pose. The DB's tensors land on ``device``.
    """
    return build_database_stacked(stack_descriptor_arrays(desc_list), poses, cfg, caps, device)


def stack_descriptor_arrays(desc_list: Sequence[Descriptors]) -> Descriptors:
    """Host (F, D, ...) NumPy stacking of per-frame descriptor sets (one
    device-to-host copy a field a frame). Only the fields the DB reads are
    kept; the others are placeholders, as in the reference."""
    f_n = len(desc_list)
    stack = lambda name, shape: np.stack([_host(getattr(d, name)).reshape(shape) for d in desc_list])
    return Descriptors(
        sides=stack("sides", (-1, 3)),
        angles=np.zeros((f_n, 1)),
        vertices=stack("vertices", (-1, 3, 3)),
        labels=stack("labels", (-1, 3)),
        node_ids=np.zeros((f_n, 1), np.int32),
        center=np.zeros((f_n, 1, 3)),
        mask=stack("mask", (-1,)),
    )


def build_database_stacked(
    descs: Descriptors,
    poses,
    cfg: DescriptorConfig = DescriptorConfig(),
    caps: CapacityConfig = CapacityConfig(),
    device: torch.device | str = "cuda",
) -> Tuple[DescriptorDB, DBBuildReport]:
    """The DB of stacked (F, D, ...) descriptors (NumPy arrays or tensors on
    any device, each field copied to the host once), built in NumPy as the
    reference builds it; poses (F, 4, 4). The DB's tensors land on
    ``device``."""
    extent = validate_key_space(cfg)

    m = _host(descs.mask).astype(bool)  # (F, D)
    f_n, d_n = m.shape
    flat_m = m.reshape(-1)
    sides = _host(descs.sides).reshape(f_n * d_n, 3)[flat_m].astype(np.float32)
    labels = _host(descs.labels).reshape(f_n * d_n, 3)[flat_m]
    verts = _host(descs.vertices).reshape(f_n * d_n, 3, 3)[flat_m].astype(np.float32)
    frames = np.repeat(np.arange(f_n, dtype=np.int32), d_n)[flat_m]

    # Insertion quantisation: round-half-up (ref STDesc.cpp:155-157).
    q = np.clip(np.floor(sides + 0.5).astype(np.int64), 0, extent - 1)
    l = np.clip(labels.astype(np.int64), 0, 12)
    code = (l[:, 0] * 13 + l[:, 1]) * 13 + l[:, 2]
    keys = (((q[:, 0] * extent + q[:, 1]) * extent + q[:, 2]) * _N_CODES + code).astype(np.int32)

    order = np.argsort(keys, kind="stable")
    keys, sides, verts, frames = keys[order], sides[order], verts[order], frames[order]
    cells = keys // _N_CODES

    if keys.size:
        _, kcounts = np.unique(keys, return_counts=True)
        max_bucket = int(kcounts.max())
        beyond = int(np.maximum(kcounts - caps.bucket_cap, 0).sum())
        _, ccounts = np.unique(cells, return_counts=True)
        n_cells = int(ccounts.size)
        max_cell = int(ccounts.max())
    else:
        max_bucket, beyond, n_cells, max_cell = 0, 0, 0, 0

    n = keys.shape[0]
    m_pad = max(_round_up(n, 128), 128)
    pad = m_pad - n
    keys_p = np.pad(keys, (0, pad), constant_values=PAD_KEY)
    sides = np.pad(sides, ((0, pad), (0, 0)))
    verts = np.pad(verts, ((0, pad), (0, 0), (0, 0)))
    frames = np.pad(frames, (0, pad))
    codes = np.where(keys_p == PAD_KEY, -1, keys_p % _N_CODES).astype(np.int32)

    # Direct-addressed cell table over the real (unpadded) rows.
    n_cells_total = extent * extent * extent
    cell_start = np.searchsorted(cells, np.arange(n_cells_total + 1, dtype=np.int64)).astype(np.int32)

    f_pad = max(_round_up(f_n, 8), 8)
    # Frame-major index over the padded table (padding rows -> bucket f_pad).
    frame_sort_key = np.where(keys_p == PAD_KEY, f_pad, frames).astype(np.int64)
    frame_rows = np.argsort(frame_sort_key, kind="stable").astype(np.int32)
    frame_start = np.searchsorted(frame_sort_key[frame_rows], np.arange(f_pad + 1)).astype(np.int32)
    fp = np.tile(np.eye(4, dtype=np.float32), (f_pad, 1, 1))
    fp[:f_n] = _host(poses).astype(np.float32).reshape(f_n, 4, 4)
    fv = np.zeros(f_pad, dtype=bool)
    fv[:f_n] = True

    # 16-bit fixed-point sides; frame ids in word 1's high half (unused by
    # the search above 65,536 keyframes, which gathers frame_ids).
    qs = np.clip(np.round(sides * 256.0), 0, 65535).astype(np.uint32)
    packed2 = np.stack(
        [qs[:, 0] | (qs[:, 1] << 16), qs[:, 2] | ((frames.astype(np.uint32) & 0xFFFF) << 16)],
        axis=-1,
    )
    table, cell_remap, code_remap, stride = _build_bucket_table_np(keys, extent, caps.bucket_table_slots, m_pad)
    fields = dict(
        keys=keys_p, codes=codes, packed2=packed2, vertices=verts, frame_ids=frames,
        cell_start=cell_start, frame_rows=frame_rows, frame_start=frame_start,
        frame_poses=fp, frame_valid=fv, bucket_table=table, cell_remap=cell_remap,
        code_remap=code_remap, table_stride=stride,
    )
    db = db_from_arrays(fields, device)
    report = DBBuildReport(
        num_rows=n, num_frames=f_n, num_cells=n_cells, max_bucket=max_bucket,
        rows_beyond_cap=beyond, max_cell_bucket=max_cell,
    )
    return db, report


def _build_bucket_table_np(keys: np.ndarray, extent: int, table_slots: int, m_pad: int):
    """Direct-addressed (dense_cell, dense_code) -> (start, len) table as
    the reference's uint32 words, from the sorted real row keys. Zero-size
    arrays (and a stride of 0) when the DB exceeds the limits (2^31 rows or
    the table budget): the search then bisects inside cells."""
    empty = (
        np.zeros((0, 2), np.uint32),
        np.zeros(0, np.int32),
        np.zeros(0, np.int32),
        np.zeros(1, np.int32),
    )
    if m_pad >= MAX_TABLE_ROWS:
        return empty
    n_cells_total = extent * extent * extent
    if keys.size == 0:
        return (
            np.zeros((table_slots, 2), np.uint32),
            np.full(n_cells_total, -1, np.int32),
            np.full(_N_CODES, -1, np.int32),
            np.ones(1, np.int32),
        )
    uniq, starts, counts = np.unique(keys, return_index=True, return_counts=True)
    ucells = uniq // _N_CODES
    ucodes = uniq % _N_CODES
    used_cells = np.unique(ucells)
    used_codes = np.unique(ucodes)
    stride = int(used_codes.size)
    if int(used_cells.size) * stride > table_slots:
        return empty
    cell_remap = np.full(n_cells_total, -1, np.int32)
    cell_remap[used_cells] = np.arange(used_cells.size, dtype=np.int32)
    code_remap = np.full(_N_CODES, -1, np.int32)
    code_remap[used_codes] = np.arange(stride, dtype=np.int32)
    table = np.zeros((table_slots, 2), np.uint32)
    slots = cell_remap[ucells].astype(np.int64) * stride + code_remap[ucodes]
    table[slots, 0] = starts.astype(np.uint32)
    table[slots, 1] = counts.astype(np.uint32)
    return table, cell_remap, code_remap, np.asarray([stride], np.int32)


# On-disk .npz format version: 2 = the packed2 / (T, 2) bucket-table layout.
DB_FORMAT_VERSION = 2
# The reference's uint32 fields, kept by the port as int32 bit patterns.
_UINT32_FIELDS = ("packed2", "bucket_table")
# Fields older writers may omit, with the reference's defaults.
_FIELD_DEFAULTS = {
    "bucket_table": np.zeros((0, 2), np.uint32),
    "cell_remap": np.zeros(0, np.int32),
    "code_remap": np.zeros(0, np.int32),
    "table_stride": np.ones(1, np.int32),
}


def db_from_arrays(fields, device: torch.device | str) -> DescriptorDB:
    """A DescriptorDB on ``device`` from the reference's field arrays (a
    dict, or anything with the fields as attributes); uint32 words
    become their int32 bit patterns."""
    get = fields.__getitem__ if isinstance(fields, dict) else lambda k: getattr(fields, k)
    out = []
    for k in DescriptorDB._fields:
        a = _host(get(k))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.array(a)).to(device))
    return DescriptorDB(*out)


def db_to_arrays(db: DescriptorDB) -> dict:
    """The DB as the reference's field arrays (uint32 words restored)."""
    out = {}
    for f in DescriptorDB._fields:
        a = getattr(db, f).cpu().numpy()
        out[f] = a.view(np.uint32) if f in _UINT32_FIELDS else a
    return out


def save_database(path: str, db: DescriptorDB) -> None:
    """Write the DB in the reference's ``.npz`` format (v2)."""
    np.savez_compressed(path, format_version=np.int32(DB_FORMAT_VERSION), **db_to_arrays(db))


def load_database(path: str, device: torch.device | str = "cuda") -> DescriptorDB:
    """Read a DB written by either package's ``save_database`` onto
    ``device``; a file of another format raises with a rebuild message."""
    with np.load(path) as z:
        version = int(z["format_version"]) if "format_version" in z else 1
        missing = [k for k in DescriptorDB._fields if k not in z and k not in _FIELD_DEFAULTS]
        if version != DB_FORMAT_VERSION or missing:
            raise ValueError(
                f"{path}: descriptor-DB file format v{version} "
                f"(missing fields: {missing or 'none'}) is incompatible with "
                f"v{DB_FORMAT_VERSION} (packed2/(T,2)-table layout): rebuild the map DB"
            )
        return db_from_arrays({k: z[k] if k in z else _FIELD_DEFAULTS[k] for k in DescriptorDB._fields}, device)
