"""Persistent per-keyframe map artifacts for the registration rerank
(port of sgtd_tpu.db.artifacts).

Keyframe clouds are pose-independent map data, so their plane-regularized
GICP covariances are computed once at map build, kept beside the DB
``.npz`` and gathered per candidate at query time: the query path does no
per-query target covariance work. ``MapArtifacts`` carries, per keyframe:
the padded cloud, its mask, its point covariances and, for the VGICP
engine, its Gaussian voxel map (``refine.vgicp.build_voxel_maps``). The
file format (v2, voxel maps as ``vmap_*`` fields) is the reference's: a
file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sgtd_tpu_torch.config import GicpConfig
from sgtd_tpu_torch.refine.gicp import point_covariances
from sgtd_tpu_torch.refine.vgicp import GaussianVoxelMap, build_voxel_maps

ARTIFACTS_FORMAT_VERSION = 2


def gicp_fingerprint(cfg: GicpConfig) -> str:
    """The GICP parameters that change the persisted covariances or voxel
    maps. Artifacts built under another fingerprint would refine against
    wrong statistics without any error."""
    return (
        f"nn={cfg.num_neighbors};eps={cfg.plane_eps};"
        f"vres={cfg.voxel_resolution};vmode={cfg.voxel_mode}"
    )


class MapArtifacts(NamedTuple):
    clouds: torch.Tensor  # (F, P, 3) float32
    masks: torch.Tensor  # (F, P) bool
    covs: torch.Tensor  # (F, P, 3, 3) float32
    vmaps: Optional[GaussianVoxelMap]  # stacked on a leading F axis, or None


def validate_map_artifacts(art: MapArtifacts, db, gcfg: GicpConfig) -> None:
    """Raise if the artifacts cannot index-align with this DB's keyframes.

    The per-candidate gathers ``art.clouds[frames]`` use frame ids from the
    DB; a stale artifact file (DB rebuilt with more keyframes or another
    padding) would be mis-gathered.
    """
    f_pad = db.frame_poses.shape[0]
    if art.clouds.shape[0] != f_pad:
        raise ValueError(
            f"map artifacts cover {art.clouds.shape[0]} (padded) keyframes "
            f"but the DB has {f_pad}: the DB was rebuilt since the artifacts "
            "were saved — rebuild them (db.artifacts.build_map_artifacts)"
        )
    if gcfg.engine == "vgicp" and art.vmaps is None and art.covs is None:
        raise ValueError("vgicp rerank needs vmaps or covs in the artifacts")


def build_map_artifacts(
    map_cloud_fn: Callable[[int], tuple],
    num_frames: int,
    cfg: GicpConfig,
    f_pad: int | None = None,
    with_vmaps: bool | None = None,
    batch: int = 64,
    device: torch.device | str = "cuda",
) -> MapArtifacts:
    """All per-keyframe artifacts, the covariances (kernel B5 on a card)
    and voxel maps in batches of ``batch`` frames.

    map_cloud_fn(frame_id) -> (points (P, 3), mask (P,)) on the host.
    ``f_pad``: pad the frame axis to this count (empty clouds) so the
    tensors align with the DB's padded ``frame_poses``. ``with_vmaps``
    defaults to (engine == "vgicp").
    """
    if with_vmaps is None:
        with_vmaps = cfg.engine == "vgicp"
    clouds, masks = zip(*(map_cloud_fn(i) for i in range(num_frames)))
    clouds = np.stack([np.asarray(c) for c in clouds]).astype(np.float32)
    masks = np.stack([np.asarray(m) for m in masks]).astype(bool)
    if f_pad is not None and f_pad > num_frames:
        pad = f_pad - num_frames
        clouds = np.pad(clouds, ((0, pad), (0, 0), (0, 0)))
        masks = np.pad(masks, ((0, pad), (0, 0)))
    clouds = torch.from_numpy(clouds).to(device)
    masks = torch.from_numpy(masks).to(device)
    parts = range(0, clouds.shape[0], batch)
    covs = torch.cat([point_covariances(clouds[i : i + batch], masks[i : i + batch], cfg) for i in parts])
    vmaps = None
    if with_vmaps:
        vms = [build_voxel_maps(clouds[i : i + batch], masks[i : i + batch], covs[i : i + batch], cfg) for i in parts]
        vmaps = GaussianVoxelMap(*(torch.cat(xs) for xs in zip(*vms)))
    return MapArtifacts(clouds=clouds, masks=masks, covs=covs, vmaps=vmaps)


def save_map_artifacts(path: str, art: MapArtifacts, gicp_cfg: GicpConfig | None = None) -> None:
    """Write the artifacts beside the DB ``.npz``. ``gicp_cfg`` stamps the
    file with :func:`gicp_fingerprint`, so a later load under other
    covariance parameters fails loudly."""
    fields = {
        "format_version": np.int32(ARTIFACTS_FORMAT_VERSION),
        "clouds": art.clouds.cpu().numpy(),
        "masks": art.masks.cpu().numpy(),
        "covs": art.covs.cpu().numpy(),
    }
    if gicp_cfg is not None:
        fields["gicp_fingerprint"] = np.asarray(gicp_fingerprint(gicp_cfg))
    if art.vmaps is not None:
        for k, v in art.vmaps._asdict().items():
            fields[f"vmap_{k}"] = v.cpu().numpy()
    np.savez_compressed(path, **fields)


def load_map_artifacts(
    path: str,
    expect_frames: int | None = None,
    expect_gicp: GicpConfig | None = None,
    device: torch.device | str = "cuda",
) -> MapArtifacts:
    """Load artifacts onto ``device``; raise on a format, frame-count or
    GICP-parameter mismatch (``expect_frames`` is the DB's PADDED keyframe
    count, ``db.frame_poses.shape[0]``)."""
    with np.load(path) as z:
        version = int(z["format_version"]) if "format_version" in z else 0
        if version not in (1, ARTIFACTS_FORMAT_VERSION):
            raise ValueError(
                f"{path}: map-artifacts format v{version} is incompatible with "
                f"v{ARTIFACTS_FORMAT_VERSION} — rebuild with build_map_artifacts"
            )
        if expect_frames is not None and z["clouds"].shape[0] != expect_frames:
            raise ValueError(
                f"{path}: artifacts cover {z['clouds'].shape[0]} (padded) "
                f"keyframes but the DB has {expect_frames} — the DB was rebuilt "
                "since these artifacts were saved; rebuild them"
            )
        if expect_gicp is not None and "gicp_fingerprint" in z:
            want = gicp_fingerprint(expect_gicp)
            got = str(z["gicp_fingerprint"])
            if got != want:
                raise ValueError(
                    f"{path}: artifacts were built under GICP params [{got}] "
                    f"but the current config is [{want}] — rebuild them"
                )
        vmaps = None
        if "vmap_keys" in z:
            vmaps = GaussianVoxelMap(
                *(torch.from_numpy(z[f"vmap_{k}"]).to(device) for k in GaussianVoxelMap._fields)
            )
        return MapArtifacts(
            clouds=torch.from_numpy(z["clouds"]).to(device),
            masks=torch.from_numpy(z["masks"]).to(device),
            covs=torch.from_numpy(z["covs"]).to(device),
            vmaps=vmaps,
        )
