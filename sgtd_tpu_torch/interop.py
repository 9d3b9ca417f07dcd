"""State carried between the JAX package and the port.

Converts the reference's NamedTuples (fields as NumPy arrays, or anything
``np.asarray`` takes) to the port's tensors on an explicit device and
back, carries keyframe clouds, masks and GICP covariances onto a device
(padded to the DB's frame count), and reads the reference's on-disk
descriptor-DB format (v2), so a map built by ``sgtd_tpu`` is served by
the port. The reference's uint32 fields (``packed2``, ``bucket_table``)
cross as their int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from sgtd_tpu_torch.db.database import DescriptorDB
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.graph.types import SemanticGraph

# The reference's on-disk DB format version (packed2 / (T, 2) bucket table).
DB_FORMAT_VERSION = 2
_UINT32_FIELDS = ("packed2", "bucket_table")
# Fields older writers may omit, with the reference's defaults.
_FIELD_DEFAULTS = {
    "bucket_table": np.zeros((0, 2), np.uint32),
    "cell_remap": np.zeros(0, np.int32),
    "code_remap": np.zeros(0, np.int32),
    "table_stride": np.ones(1, np.int32),
}


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(cls, obj, device):
    return cls(*(_to_tensor(getattr(obj, f), device) for f in cls._fields))


def graph_from_numpy(graph, device) -> SemanticGraph:
    """A reference SemanticGraph (single or stacked) as tensors on ``device``."""
    return _convert(SemanticGraph, graph, device)


def descriptors_from_numpy(descs, device) -> Descriptors:
    """Reference Descriptors (stacked, leading frame axis) as tensors."""
    return _convert(Descriptors, descs, device)


def db_from_numpy(db, device) -> DescriptorDB:
    """A reference DescriptorDB as tensors (uint32 words as int32 bits)."""
    return _convert(DescriptorDB, db, device)


def db_to_numpy(db: DescriptorDB) -> dict:
    """The port's DB as the reference's field arrays (uint32 words restored)."""
    out = {}
    for f in DescriptorDB._fields:
        a = getattr(db, f).cpu().numpy()
        out[f] = a.view(np.uint32) if f in _UINT32_FIELDS else a
    return out


def map_clouds_to_device(clouds, masks, covs=None, device="cpu", f_pad: int | None = None):
    """Keyframe clouds (F, P, 3), masks (F, P) and covariances
    (F, P, 3, 3) | None as tensors on ``device``, padded with empty clouds
    (zero points, mask False, identity covariances, as the reference's
    ``point_covariances`` gives them) to ``f_pad`` rows, the row count of
    the DB's ``frame_poses`` that ``localize_refined`` requires."""
    clouds = np.asarray(clouds, np.float32)
    masks = np.asarray(masks, bool)
    pad = 0 if f_pad is None else f_pad - clouds.shape[0]
    if pad < 0:
        raise ValueError(f"{clouds.shape[0]} clouds exceed f_pad {f_pad}")
    clouds = np.pad(clouds, ((0, pad), (0, 0), (0, 0)))
    masks = np.pad(masks, ((0, pad), (0, 0)))
    out = [_to_tensor(clouds, device), _to_tensor(masks, device)]
    if covs is not None:
        covs = np.asarray(covs, np.float32)
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (pad,) + covs.shape[1:])
        out.append(_to_tensor(np.concatenate([covs, eye]), device))
    else:
        out.append(None)
    return tuple(out)


def to_numpy(result):
    """A port result (GicpResult, RefinedResult, LocalizationResult, ... —
    NamedTuples of tensors, nested ones included) with NumPy fields."""
    return type(result)(
        *(
            to_numpy(v) if isinstance(v, tuple) else v.detach().cpu().numpy()
            for v in result
        )
    )


def load_database(path: str, device) -> DescriptorDB:
    """Read a DB written by ``sgtd_tpu.db.database.save_database``."""
    with np.load(path) as z:
        version = int(z["format_version"]) if "format_version" in z else 1
        missing = [
            k for k in DescriptorDB._fields if k not in z and k not in _FIELD_DEFAULTS
        ]
        if version != DB_FORMAT_VERSION or missing:
            raise ValueError(
                f"{path}: descriptor-DB file format v{version} "
                f"(missing fields: {missing or 'none'}) is incompatible with "
                f"v{DB_FORMAT_VERSION} (packed2/(T,2)-table layout): rebuild the map DB"
            )
        return DescriptorDB(
            *(
                _to_tensor(z[k] if k in z else _FIELD_DEFAULTS[k], device)
                for k in DescriptorDB._fields
            )
        )
