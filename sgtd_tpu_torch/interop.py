"""State carried between the JAX package and the port.

Converts the reference's NamedTuples (fields as NumPy arrays, or anything
``np.asarray`` takes) to the port's tensors on an explicit device and
back, its config dataclasses, map artifacts and map index to the port's,
the front end's results (clusters, FEC labels, NDT maps) and class
routings,
carries keyframe clouds, masks and GICP covariances onto a device (padded
to the DB's frame count), pads a DB's frame axis, and reads the
reference's on-disk descriptor-DB format (v2, through
``db.database.load_database``), so a map built by ``sgtd_tpu`` is served
by the port. The reference's uint32 fields (``packed2``, ``bucket_table``)
cross as their int32 bit patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgtd_tpu_torch.config import SGTDConfig
from sgtd_tpu_torch.db import database
from sgtd_tpu_torch.db.database import DBBuildReport, DescriptorDB
from sgtd_tpu_torch.desc.triangles import Descriptors
from sgtd_tpu_torch.graph.types import SemanticGraph


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(cls, obj, device):
    return cls(*(_to_tensor(getattr(obj, f), device) for f in cls._fields))


def config_from_reference(cfg, cls=SGTDConfig):
    """The port's config with the values of a reference config: any object
    with the same dataclass fields (``sgtd_tpu.config.SGTDConfig``, or one
    of its parts with the matching ``cls``), nested configs included."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        sub = type(getattr(cls(), f.name))
        kw[f.name] = config_from_reference(v, sub) if dataclasses.is_dataclass(sub) else v
    return cls(**kw)


def graph_from_numpy(graph, device) -> SemanticGraph:
    """A reference SemanticGraph (single or stacked) as tensors on ``device``."""
    return _convert(SemanticGraph, graph, device)


def descriptors_from_numpy(descs, device) -> Descriptors:
    """Reference Descriptors (stacked, leading frame axis) as tensors."""
    return _convert(Descriptors, descs, device)


def db_from_numpy(db, device) -> DescriptorDB:
    """A reference DescriptorDB as tensors (uint32 words as int32 bits)."""
    return database.db_from_arrays(db, device)


def db_to_numpy(db: DescriptorDB) -> dict:
    """The port's DB as the reference's field arrays (uint32 words restored)."""
    return database.db_to_arrays(db)


def pad_frames(db: DescriptorDB, f_pad: int) -> DescriptorDB:
    """``db`` with its frame axis padded to ``f_pad`` keyframes: the extra
    frames are invalid and own no rows, so every search over it gives the
    same live candidates. Past 65,536 frames (or 2,048) this puts a map on
    the wide-DB paths of the search (frame-id gathers, the argsort pair
    grouping, kernel B6) with the same rows."""
    f_old = db.frame_poses.shape[0]
    if f_pad < f_old:
        raise ValueError(f"f_pad {f_pad} is below the DB's {f_old} frames")
    dev = db.frame_poses.device
    fp = torch.eye(4, dtype=torch.float32, device=dev).repeat(f_pad, 1, 1)
    fp[:f_old] = db.frame_poses
    fv = torch.zeros(f_pad, dtype=torch.bool, device=dev)
    fv[:f_old] = db.frame_valid
    fs = db.frame_start[-1].repeat(f_pad + 1)
    fs[: f_old + 1] = db.frame_start
    return db._replace(frame_poses=fp, frame_valid=fv, frame_start=fs)


def map_clouds_to_device(clouds, masks, covs=None, device="cuda", f_pad: int | None = None):
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


def map_artifacts_from_numpy(art, device):
    """Reference ``MapArtifacts`` (fields as NumPy arrays, its voxel maps
    a ``GaussianVoxelMap`` of arrays or None) as the port's, on
    ``device``."""
    from sgtd_tpu_torch.db.artifacts import MapArtifacts
    from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap

    return MapArtifacts(
        clouds=_to_tensor(np.asarray(art.clouds, np.float32), device),
        masks=_to_tensor(np.asarray(art.masks, bool), device),
        covs=_to_tensor(np.asarray(art.covs, np.float32), device),
        vmaps=None if art.vmaps is None else _convert(GaussianVoxelMap, art.vmaps, device),
    )


def map_artifacts_to_numpy(art) -> dict:
    """The port's ``MapArtifacts`` as the reference's field arrays; ``vmaps``
    a dict of the voxel maps' fields, or None."""
    return {
        "clouds": art.clouds.cpu().numpy(), "masks": art.masks.cpu().numpy(),
        "covs": art.covs.cpu().numpy(),
        "vmaps": None if art.vmaps is None else {k: v.cpu().numpy() for k, v in art.vmaps._asdict().items()},
    }


def map_index_from_reference(index, device):
    """A reference ``eval.runner.MapIndex`` (DB, tuned config, build
    report) as the port's, its DB on ``device``."""
    from sgtd_tpu_torch.eval.runner import MapIndex

    return MapIndex(
        db=db_from_numpy(index.db, device),
        config=config_from_reference(index.config),
        build_seconds=index.build_seconds,
        report=DBBuildReport(**dataclasses.asdict(index.report)),
    )


def cluster_result_from_numpy(res, device):
    """A reference ``cluster.dcvc.ClusterResult`` as the port's, on ``device``."""
    from sgtd_tpu_torch.cluster.dcvc import ClusterResult

    return _convert(ClusterResult, res, device)


def fec_result_from_numpy(res, device):
    """A reference ``cluster.fec.FecResult`` as the port's, on ``device``."""
    from sgtd_tpu_torch.cluster.fec import FecResult

    return _convert(FecResult, res, device)


def ndt_map_from_numpy(ndt, device):
    """A reference ``refine.ndt.NdtMap`` as the port's, on ``device``, so
    the port's ``ndt_align`` runs on a map the reference built."""
    from sgtd_tpu_torch.refine.ndt import NdtMap

    return _convert(NdtMap, ndt, device)


def routing_from_reference(routing):
    """A reference ``graph.build.ClassRouting`` as the port's: its fields
    are plain tuples and ints, carried over unchanged."""
    from sgtd_tpu_torch.graph.build import ClassRouting

    return ClassRouting(**{f.name: getattr(routing, f.name) for f in dataclasses.fields(ClassRouting)})


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
    """Read a DB written by ``sgtd_tpu.db.database.save_database`` (or the
    port's)."""
    return database.load_database(path, device)
