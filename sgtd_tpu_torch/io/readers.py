"""Dataset readers (port of sgtd_tpu.io.readers, NumPy only): KITTI/MulRan
.bin scans, SemanticKITTI .label files, pose tables, and the train-id remap.

Replicates the reference's binary formats and conventions:
  * .bin = float32 (x, y, z, intensity) records (ref get_json.cpp:47-58,
    readBinFile semantic_graph_localization.cpp:160-173);
  * .label = uint32 per point, semantic = low 16 bits, instance = high
    16 bits (ref get_json.cpp:79-88);
  * MulRan pose.txt: "timestamp, r11,r12,r13,tx,r21,...,tz" rows associated
    to scans by closest timestamp <= scan time, with per-sequence UTM offsets
    (ref get_json.cpp:427-490);
  * SemanticKITTI poses.txt: 12 floats per line (3x4 row-major), calibrated
    via calib.txt Tr (standard KITTI odometry convention);
  * the SemanticKITTI ``learning_map`` raw-label -> train-id remap
    (ref Kitti_clutering.cpp:125-177, the standard semantic-kitti.yaml map).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

# semantic-kitti.yaml learning_map: raw label -> train id (0..19, 0=ignore).
# Ref Kitti_clutering.cpp:125-177. Train-id space matches get_json.cpp's
# class routing (car=0 ... traffic-sign=18 after the -1 shift used there);
# we use the common convention 0=unlabeled, 1=car, ..., 19=traffic-sign and
# shift to the reference's 0-based space via ``to_reference_train_ids``.
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

_LUT = np.zeros(260, dtype=np.int32)
for k, v in LEARNING_MAP.items():
    _LUT[k] = v

# MulRan UTM offsets per sequence family (ref get_json.cpp:470-490).
MULRAN_UTM_OFFSETS = {
    "kaist": (353050.0, 4026791.0, 19.0),
    "dcc": (355630.0, 402670.0, 19.0),
    "riverside": (353610.0, 4025986.0, 19.0),
    "sejong": (345100.0, 4037588.0, 19.0),
}

# MulRan base -> Ouster extrinsic (ref semantic_graph_localization.cpp:196-199).
MULRAN_BASE2OUSTER = np.array(
    [
        [-0.99998295, 0.00583984, -0.00000524, 1.70430303],
        [-0.00583984, -0.99998295, 0.00000175, -0.01105054],
        [-0.00000523, 0.00000178, 1.0, -1.80469106],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)

# MCD ntu extrinsic (ref semantic_graph_localization.cpp:203-206).
MCD_BASE2OUSTER = np.array(
    [
        [0.9999346552051229, 0.003477624535771754, -0.010889970036688295, -0.060649229060416594],
        [0.003587143302461965, -0.9999430279821171, 0.010053516443599904, -0.012837544242408117],
        [-0.010854387257665576, -0.01009192338171122, -0.999890161647627, -0.020492606896077407],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def read_bin(path: str) -> np.ndarray:
    """Read a KITTI/MulRan .bin scan -> (N, 4) float32 [x, y, z, intensity]."""
    data = np.fromfile(path, dtype=np.float32)
    n = data.size // 4
    return data[: n * 4].reshape(n, 4)


def read_bin_wild(path: str) -> np.ndarray:
    """Read a Wild-Places-style .bin scan -> (N, 3) float32 [x, y, z].

    The wild pipeline's scans carry no intensity channel (3-float stride,
    ref get_json_wild.cpp:119-131 vs get_json.cpp:47-58's 4-float)."""
    data = np.fromfile(path, dtype=np.float32)
    n = data.size // 3
    return data[: n * 3].reshape(n, 3)


def read_label(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .label file -> (semantic (N,), instance (N,)) int32."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32), (raw >> 16).astype(np.int32)


def remap_semantic_kitti(raw_sem: np.ndarray) -> np.ndarray:
    """Raw SemanticKITTI labels -> train ids (0..19)."""
    return _LUT[np.clip(raw_sem, 0, 259)]


def to_reference_train_ids(train_ids: np.ndarray) -> np.ndarray:
    """Shift the 0=unlabeled convention to the reference's 0-based space
    (0=car ... 18=traffic-sign, 19=ignore), matching get_json.cpp's
    class constants."""
    out = train_ids.astype(np.int32) - 1
    out[out < 0] = 19
    return out


def read_kitti_poses(pose_path: str, calib_path: str | None = None) -> np.ndarray:
    """KITTI odometry poses (camera frame), optionally moved to the LiDAR
    frame via calib Tr: T_lidar = Tr^-1 @ T_cam @ Tr. Returns (N, 4, 4)."""
    rows = np.loadtxt(pose_path).reshape(-1, 3, 4)
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :] = rows
    if calib_path is not None:
        tr = None
        with open(calib_path) as f:
            for line in f:
                if line.startswith("Tr"):
                    tr = np.asarray(
                        [float(x) for x in line.split(":", 1)[1].split()]
                    ).reshape(3, 4)
        if tr is None:
            raise ValueError(f"no Tr entry in {calib_path}")
        T = np.eye(4)
        T[:3, :] = tr
        poses = np.linalg.inv(T) @ poses @ T
    return poses.astype(np.float32)


def read_mulran_poses(pose_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """MulRan global_pose.csv / pose.txt -> (timestamps (N,), poses (N,4,4)).

    Rows are "stamp, r11,r12,r13,tx, r21,...,ty, r31,...,tz".
    """
    stamps, mats = [], []
    with open(pose_path) as f:
        for line in f:
            parts = line.replace(",", " ").split()
            if len(parts) < 13:
                continue
            # Parse as int directly: nanosecond stamps exceed float64
            # precision (19 digits vs ~16).
            s = parts[0]
            stamps.append(int(s) if s.lstrip("-").isdigit() else int(float(s)))
            vals = np.asarray([float(x) for x in parts[1:13]])
            T = np.eye(4, dtype=np.float64)
            T[:3, :] = vals.reshape(3, 4)
            mats.append(T)
    return np.asarray(stamps, dtype=np.int64), np.asarray(mats, dtype=np.float64)


def apply_mulran_utm_offset(poses: np.ndarray, sequence: str) -> np.ndarray:
    """Subtract the per-sequence-family UTM offset (ref get_json.cpp:470-490)."""
    seq = sequence.lower()
    for fam, (ox, oy, oz) in MULRAN_UTM_OFFSETS.items():
        if fam in seq:
            out = poses.copy()
            out[..., 0, 3] -= ox
            out[..., 1, 3] -= oy
            out[..., 2, 3] -= oz
            return out
    return poses


def associate_by_timestamp(
    scan_stamps: np.ndarray, pose_stamps: np.ndarray
) -> np.ndarray:
    """Index of the pose row whose timestamp is closest below each scan
    (ref get_json.cpp:427-449: latest pose with stamp <= scan, falling back
    to the first later one when closer)."""
    idx = np.searchsorted(pose_stamps, scan_stamps, side="right") - 1
    idx = np.clip(idx, 0, len(pose_stamps) - 1)
    nxt = np.clip(idx + 1, 0, len(pose_stamps) - 1)
    d_lo = np.abs(scan_stamps - pose_stamps[idx])
    d_hi = np.abs(pose_stamps[nxt] - scan_stamps)
    return np.where(d_hi < d_lo, nxt, idx)


def list_scans(directory: str, ext: str = ".bin") -> List[str]:
    out = []
    for root, _, files in os.walk(directory):
        for f in files:
            if f.endswith(ext):
                out.append(os.path.join(root, f))
    return sorted(out)


def corrupt_labels(
    sem: np.ndarray, rate: float, rng: np.random.Generator, bad_label: int = 20
) -> np.ndarray:
    """The reference's label_deter_rate robustness knob: rewrite a random
    fraction of semantic labels to an out-of-range class
    (ref semantic_graph_localization.cpp:91-97)."""
    if rate <= 0:
        return sem
    out = sem.copy()
    out[rng.uniform(size=sem.shape) <= rate] = bad_label
    return out


def write_bin(path: str, points: np.ndarray, intensity: np.ndarray | None = None):
    """Write a KITTI-format .bin scan (x, y, z, intensity float32 records,
    ref utility.hpp saveBinFile:661-685)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    inten = (
        np.asarray(intensity, np.float32).reshape(-1, 1)
        if intensity is not None
        else np.ones((len(pts), 1), np.float32)
    )
    np.hstack([pts, inten]).astype(np.float32).tofile(path)


def write_label(path: str, sem: np.ndarray, inst: np.ndarray | None = None):
    """Write a SemanticKITTI .label file (sem low16 | inst high16)."""
    sem = np.asarray(sem, np.uint32) & 0xFFFF
    inst = np.asarray(inst, np.uint32) if inst is not None else np.zeros_like(sem)
    ((inst << 16) | sem).astype(np.uint32).tofile(path)
