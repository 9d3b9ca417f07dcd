"""Geometric-hash keys of triangle descriptors (port of sgtd_tpu.desc.keys).

Keys pack (quantised sides x, y, z, label code) into one sortable int32:
``((x * X + y) * X + z) * 2197 + code13`` with X = floor(max_len * scale) + 2.
DB insertion quantises with round-half-up (``db_keys``, reference
STDesc.cpp:155-161). Query probes quantise with C truncation over the
27-cell neighbourhood, gated by ||sides - (voxel + 0.5)|| < 1.5 (reference
STDesc.cpp:358-369): ``probe_keys``, or ``probe_cells`` split into the
(cell, code) pair the sorted DB is laid out by.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sgtd_tpu_torch.config import DescriptorConfig
from sgtd_tpu_torch.utils import sqrt_rn

_N_CODES = 13 * 13 * 13  # 2197

_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
).reshape(27, 3)


def key_extent(cfg: DescriptorConfig) -> int:
    """Number of quantised side-length cells per axis."""
    return int(np.floor(cfg.max_len * cfg.scale)) + 2


def validate_key_space(cfg: DescriptorConfig) -> int:
    """``key_extent``, or ValueError when the packed key overflows int32."""
    x = key_extent(cfg)
    max_key = x * x * x * _N_CODES
    if max_key >= 2**31:
        raise ValueError(
            f"descriptor key space {max_key} overflows int32; use a coarser "
            f"std_side_resolution (max_len*scale must stay <= ~96 cells)"
        )
    return x


def pack_label_code(labels: torch.Tensor) -> torch.Tensor:
    """Injective base-13 packing of the (A, B, C) vertex label triple."""
    l = labels.to(torch.int32).clamp(0, 12)
    return (l[..., 0] * 13 + l[..., 1]) * 13 + l[..., 2]


def pack_key(x, y, z, code, extent: int) -> torch.Tensor:
    """The int32 key of quantised sides (each clamped to [0, extent)) and
    a packed label code."""
    x = x.clamp(0, extent - 1)
    y = y.clamp(0, extent - 1)
    z = z.clamp(0, extent - 1)
    return ((x * extent + y) * extent + z) * _N_CODES + code


def db_keys(sides: torch.Tensor, labels: torch.Tensor, cfg: DescriptorConfig) -> torch.Tensor:
    """Insertion keys: round-half-up quantisation (ref STDesc.cpp:155-161)."""
    q = torch.floor(sides + 0.5).to(torch.int32)
    return pack_key(q[..., 0], q[..., 1], q[..., 2], pack_label_code(labels), key_extent(cfg))


def _probe_voxels(sides: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 27 truncated neighbour voxels (..., 27, 3) int32 of each side
    triple and the 1.5-cell gate (..., 27) bool."""
    offs = torch.as_tensor(_OFFSETS, dtype=torch.float32, device=sides.device)
    voxel = torch.trunc(sides[..., None, :] + offs).to(torch.int32)
    center = voxel.to(torch.float32) + 0.5
    d = sides[..., None, :] - center
    s = d * d
    return voxel, sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2]) < 1.5


def probe_cells(
    sides: torch.Tensor, labels: torch.Tensor, cfg: DescriptorConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query cells over the 27-voxel neighbourhood plus the 1.5-cell gate.

    Returns (cells (..., 27) int32 flat cell ids, code (...,) int32 packed
    label triple, gate (..., 27) bool).
    """
    extent = key_extent(cfg)
    voxel, gate = _probe_voxels(sides)
    v = voxel.clamp(0, extent - 1)
    cells = (v[..., 0] * extent + v[..., 1]) * extent + v[..., 2]
    return cells, pack_label_code(labels), gate


def probe_keys(
    sides: torch.Tensor, labels: torch.Tensor, cfg: DescriptorConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query keys over the 27-voxel neighbourhood plus the 1.5-cell gate.

    Returns (keys (..., 27) int32, gate (..., 27) bool): the probe loop at
    STDesc.cpp:358-369, voxel = trunc(side + offset), taken only when
    ||sides - (voxel + 0.5)|| < 1.5.
    """
    voxel, gate = _probe_voxels(sides)
    code = pack_label_code(labels)[..., None]
    return pack_key(voxel[..., 0], voxel[..., 1], voxel[..., 2], code, key_extent(cfg)), gate
