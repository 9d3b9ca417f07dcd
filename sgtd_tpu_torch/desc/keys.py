"""Geometric-hash keys of triangle descriptors (port of sgtd_tpu.desc.keys).

Keys pack (quantised sides x, y, z, label code) into one sortable int32:
``((x * X + y) * X + z) * 2197 + code13`` with X = floor(max_len * scale) + 2.
Query probes quantise with C truncation over the 27-cell neighbourhood,
gated by ||sides - (voxel + 0.5)|| < 1.5 (reference STDesc.cpp:358-369).
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


def probe_cells(
    sides: torch.Tensor, labels: torch.Tensor, cfg: DescriptorConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query cells over the 27-voxel neighbourhood plus the 1.5-cell gate.

    Returns (cells (..., 27) int32 flat cell ids, code (...,) int32 packed
    label triple, gate (..., 27) bool).
    """
    extent = key_extent(cfg)
    offs = torch.as_tensor(_OFFSETS, dtype=torch.float32, device=sides.device)
    voxel = torch.trunc(sides[..., None, :] + offs).to(torch.int32)
    center = voxel.to(torch.float32) + 0.5
    d = sides[..., None, :] - center
    s = d * d
    gate = sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2]) < 1.5
    v = voxel.clamp(0, extent - 1)
    cells = (v[..., 0] * extent + v[..., 1]) * extent + v[..., 2]
    return cells, pack_label_code(labels), gate
