"""On-device descriptor-database assembly (port of sgtd_tpu.db.device_build).

One stable key sort, gathers and a searchsorted cell table, all on the
descriptors' device; only the bucket-stat scalars come to the host. The
result has the reference's layout row for row: the key sort is stable, so
rows inside a bucket stay frame-ascending, and padding rows (PAD_KEY) sort
to the end.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sgtd_tpu_torch.config import DescriptorConfig
from sgtd_tpu_torch.db.database import (
    DBBuildReport,
    DescriptorDB,
    MAX_TABLE_ROWS,
    PAD_KEY,
)
from sgtd_tpu_torch.desc.keys import _N_CODES, validate_key_space
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.match.search import scan_totals


def _as_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _first_of_run(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    head = torch.ones(1, dtype=torch.bool, device=x.device)
    return torch.cat([head, x[1:] != x[:-1]]) & valid


def _keys_and_words(sides, labels, frames, valid, extent):
    """Sort keys, label codes and packed2 words of descriptor rows (M, ...)."""
    i32 = torch.int32
    q = torch.floor(sides + 0.5).to(i32).clamp(0, extent - 1)
    l = labels.clamp(0, 12)
    code = (l[:, 0] * 13 + l[:, 1]) * 13 + l[:, 2]
    key = ((q[:, 0] * extent + q[:, 1]) * extent + q[:, 2]) * _N_CODES + code
    key = torch.where(valid, key, PAD_KEY).to(i32)
    qs = torch.round(sides * 256.0).clamp(0, 65535).to(torch.int64)
    packed2 = torch.stack(
        [
            _as_int32_bits(qs[:, 0] | (qs[:, 1] << 16)),
            _as_int32_bits(qs[:, 2] | ((frames.to(torch.int64) & 0xFFFF) << 16)),
        ],
        dim=-1,
    )
    return key, torch.where(valid, code, -1).to(i32), packed2


def _frame_index(frames_s, valid_s, f_pad):
    """Frame-major row index: (frame_rows, frame_start)."""
    dev = frames_s.device
    frame_sort_key = torch.where(valid_s, frames_s, f_pad).to(torch.int32)
    frame_rows = torch.argsort(frame_sort_key, stable=True).to(torch.int32)
    frame_start = torch.searchsorted(
        frame_sort_key[frame_rows.long()],
        torch.arange(f_pad + 1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    return frame_rows, frame_start


def _flat_rows(descs: Descriptors, extent: int, frame0: int = 0):
    """Rows of stacked (F, D, ...) descriptors, flattened to (F * D, ...):
    (keys, codes, packed2 words, vertices, frame ids from ``frame0``,
    valid)."""
    f_n, d_n = descs.mask.shape
    m = f_n * d_n
    dev = descs.sides.device
    frames = torch.arange(f_n, dtype=torch.int32, device=dev).repeat_interleave(d_n) + frame0
    valid = descs.mask.reshape(m)
    key, code, words = _keys_and_words(
        descs.sides.reshape(m, 3), descs.labels.reshape(m, 3), frames, valid, extent
    )
    return key, code, words, descs.vertices.reshape(m, 3, 3), frames, valid


def _assemble(rows, poses: torch.Tensor, extent: int, table_slots: int):
    """The DB of flat rows (``_flat_rows``'s tuple) owned by frames with
    (F, 4, 4) ``poses``, and its bucket stats."""
    key, code, words, verts, frames, valid = rows
    f_n, m = poses.shape[0], key.shape[0]
    dev = key.device
    i32 = torch.int32

    key_s, order = torch.sort(key, stable=True)
    codes = code[order]
    packed2 = words[order]
    verts_s = verts[order]
    frames_s = frames[order]
    valid_s = valid[order]

    n_cells_total = extent * extent * extent
    cells = torch.where(valid_s, key_s // _N_CODES, n_cells_total).to(i32)
    cell_start = torch.searchsorted(
        cells, torch.arange(n_cells_total + 1, dtype=i32, device=dev),
        out_int32=True,
    )

    f_pad = max(-(-f_n // 8) * 8, 8)
    frame_rows, frame_start = _frame_index(frames_s, valid_s, f_pad)

    # Bucket stats: run lengths over the sorted keys and cells.
    valid_i = valid_s.to(i32)
    is_first = _first_of_run(key_s, valid_s)
    group = torch.cumsum(is_first.to(i32), 0, dtype=i32) - 1
    counts = torch.zeros(m, dtype=i32, device=dev).scatter_add_(
        0, group.clamp(min=0).long(), valid_i
    )
    cfirst = _first_of_run(cells, valid_s)
    cgroup = torch.cumsum(cfirst.to(i32), 0, dtype=i32) - 1
    ccounts = torch.zeros(m, dtype=i32, device=dev).scatter_add_(
        0, cgroup.clamp(min=0).long(), valid_i
    )

    fp = torch.eye(4, dtype=torch.float32, device=dev).repeat(f_pad, 1, 1)
    fp[:f_n] = poses.to(torch.float32)
    fv = torch.zeros(f_pad, dtype=torch.bool, device=dev)
    fv[:f_n] = True

    # Direct-addressed bucket table: one write per bucket's first row.
    # Writes the reference drops (out-of-range slots) are masked out here.
    mark = torch.zeros(_N_CODES, dtype=i32, device=dev)
    mark[codes[valid_s].long()] = 1
    code_remap = torch.where(
        mark > 0, torch.cumsum(mark, 0, dtype=i32) - 1, -1
    ).to(i32)
    stride = mark.sum(dtype=i32)
    cell_remap = torch.full((n_cells_total,), -1, dtype=i32, device=dev)
    cell_remap[cells[valid_s].long()] = cgroup[valid_s]
    blen = counts[group.clamp(min=0).long()]
    rowi = torch.arange(m, dtype=i32, device=dev)
    dcode = code_remap[codes.clamp(0, _N_CODES - 1).long()]
    slot = cgroup.to(torch.int64) * stride + dcode
    write = is_first & (slot < table_slots)
    bucket_table = torch.zeros((table_slots, 2), dtype=i32, device=dev)
    bucket_table[slot[write]] = torch.stack([rowi[write], blen[write]], dim=-1)

    db = DescriptorDB(
        keys=key_s,
        codes=codes,
        packed2=packed2,
        vertices=verts_s,
        frame_ids=frames_s,
        cell_start=cell_start,
        frame_rows=frame_rows,
        frame_start=frame_start,
        frame_poses=fp,
        frame_valid=fv,
        bucket_table=bucket_table,
        cell_remap=cell_remap,
        code_remap=code_remap,
        table_stride=stride[None],
    )
    stats = torch.stack(
        [
            valid_i.sum(dtype=i32),
            is_first.sum(dtype=i32),
            counts.max(),
            cfirst.sum(dtype=i32),
            ccounts.max(),
            stride,
        ]
    )
    return db, stats


def _finish(db, stats, num_frames, bucket_cap_for_report, table_slots):
    """Host side: empty the direct table past its limits; build the report."""
    n_rows, _, max_bucket, n_cells, max_cell, stride = (
        int(x) for x in stats.cpu().tolist()
    )
    if db.keys.shape[0] >= MAX_TABLE_ROWS or n_cells * stride > table_slots:
        dev = db.keys.device
        db = db._replace(
            bucket_table=torch.zeros((0, 2), dtype=torch.int32, device=dev),
            cell_remap=torch.zeros(0, dtype=torch.int32, device=dev),
            code_remap=torch.zeros(0, dtype=torch.int32, device=dev),
        )
    report = DBBuildReport(
        num_rows=n_rows,
        num_frames=num_frames,
        num_cells=n_cells,
        max_bucket=max_bucket,
        rows_beyond_cap=0 if max_bucket <= bucket_cap_for_report else -1,
        max_cell_bucket=max_cell,
    )
    return db, report


def build_database_on_device(
    descs: Descriptors,
    poses: torch.Tensor,
    cfg: DescriptorConfig = DescriptorConfig(),
    bucket_cap_for_report: int = 256,
    table_slots: int = 1 << 23,
) -> Tuple[DescriptorDB, DBBuildReport]:
    """Assemble the DB from stacked (F, D, ...) descriptors; poses (F, 4, 4)."""
    extent = validate_key_space(cfg)
    db, stats = _assemble(_flat_rows(descs, extent), poses, extent, table_slots)
    return _finish(
        db, stats, descs.mask.shape[0], bucket_cap_for_report, table_slots
    )


def build_database_calibrated(
    descs: Descriptors,
    poses: torch.Tensor,
    sample_descs: Descriptors,
    cfg: DescriptorConfig = DescriptorConfig(),
    bucket_cap_for_report: int = 256,
    table_slots: int = 1 << 23,
) -> Tuple[DescriptorDB, DBBuildReport, torch.Tensor]:
    """build_database_on_device plus the probe-scan total of each sample
    query, (S,) int32 (feed ``totals.max()`` to
    ``match.search.fit_scan_slots``)."""
    extent = validate_key_space(cfg)
    db, stats = _assemble(_flat_rows(descs, extent), poses, extent, table_slots)
    totals = scan_totals(db, sample_descs, cfg)
    db, report = _finish(
        db, stats, descs.mask.shape[0], bucket_cap_for_report, table_slots
    )
    return db, report, totals


def append_database(
    db: DescriptorDB,
    new_descs: Descriptors,
    new_poses: torch.Tensor,
    cfg: DescriptorConfig = DescriptorConfig(),
) -> Tuple[DescriptorDB, DBBuildReport]:
    """Append keyframes to a DB: stacked (F_new, D, ...) descriptors and
    their (F_new, 4, 4) poses, frame ids continuing after the DB's valid
    frames. The DB's rows and the new ones are assembled again in one
    stable sort, under the DB's table size; the report caps no bucket."""
    extent = validate_key_space(cfg)
    f_old = int(db.frame_valid.sum())
    old = (db.keys, db.codes, db.packed2, db.vertices, db.frame_ids, db.keys != PAD_KEY)
    new = _flat_rows(new_descs, extent, frame0=f_old)
    rows = tuple(torch.cat([a, b]) for a, b in zip(old, new))
    poses = torch.cat([db.frame_poses[:f_old], new_poses.to(db.frame_poses)])
    table_slots = int(db.bucket_table.shape[0]) or (1 << 23)
    new_db, stats = _assemble(rows, poses, extent, table_slots)
    new_db, report = _finish(new_db, stats, poses.shape[0], 0, table_slots)
    if not new_db.has_direct_table:
        # The reference's host-built table stores a stride of 0 without a table.
        new_db = new_db._replace(table_stride=torch.zeros_like(new_db.table_stride))
    return new_db, dataclasses.replace(report, rows_beyond_cap=0)
