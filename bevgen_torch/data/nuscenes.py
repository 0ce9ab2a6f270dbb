"""nuScenes multi-camera dataset reader, without the nuscenes-devkit.

The port's copy of `bevgen_tpu/data/nuscenes.py`: the same samples, key for
key, for the same tree. The devkit's `NuScenes` class loads the dataset's
plain-JSON relational tables and joins them; `NuScenesTables` reads those
tables directly. Scene splits ship as data files (`data/splits/{train,val,
test}.txt`, the official nuScenes trainval split). cv2 and PIL are imported
inside `NuScenesDataset.__getitem__`, so importing this module pulls in
neither.

Sample schema (the batch contract of `data/argoverse.py`): image
[cam,h,w,3] float, segmentation [256,256,12] (the channel layout of
`nuscenes_raster`), intrinsics(_inv) [cam,3,3], extrinsics(_inv) [cam,4,4]
(ego->cam: the nuScenes convention, the opposite of Argoverse's), cam_name,
sample_token, dataset='nuscenes'.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bevgen_torch.data import camera_geometry as cg
from bevgen_torch.data import nuscenes_raster as nr

NUSCENES_CAMERAS = ("CAM_FRONT", "CAM_BACK", "CAM_FRONT_RIGHT",
                    "CAM_FRONT_LEFT", "CAM_BACK_RIGHT", "CAM_BACK_LEFT")

_SPLITS_DIR = Path(__file__).parent / "splits"


def scene_split(split: str) -> List[str]:
    """Scene-name lists for train/val/test (reference
    bev_utils/splits/*.txt — the official nuScenes trainval split)."""
    path = _SPLITS_DIR / f"{split}.txt"
    if not path.exists():
        raise ValueError(f"unknown nuScenes split {split!r} "
                         f"(have: {[p.stem for p in _SPLITS_DIR.glob('*.txt')]})")
    return [ln.strip() for ln in path.read_text().splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# quaternion helpers (pyquaternion equivalents; nuScenes stores wxyz)
# ---------------------------------------------------------------------------


def quat_to_rotmat(q) -> np.ndarray:
    """(w,x,y,z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)]])


def quat_yaw(q) -> float:
    """Rotation about +z (pyquaternion yaw_pitch_roll[0] convention:
    yaw extracted from the rotated x-axis projected to the xy plane)."""
    R = quat_to_rotmat(q)
    return float(np.arctan2(R[1, 0], R[0, 0]))


def pose_flat(rotation_q, translation, inv: bool = False) -> np.ndarray:
    """Yaw-only ('flat') pose (nuscenes_helper.py:152-161
    get_pose(flat=True)): rotation reduced to its z-axis yaw."""
    yaw = quat_yaw(rotation_q)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = np.asarray(translation, np.float64)
    out = np.eye(4)
    if inv:
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ t
    else:
        out[:3, :3] = R
        out[:3, 3] = t
    return out


def se3(rotation_q, translation, inv: bool = False) -> np.ndarray:
    """4x4 SE(3) from a (w,x,y,z) quaternion + translation
    (devkit transform_matrix equivalent)."""
    R = quat_to_rotmat(rotation_q)
    t = np.asarray(translation, np.float64)
    out = np.eye(4)
    if inv:
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ t
    else:
        out[:3, :3] = R
        out[:3, 3] = t
    return out


# ---------------------------------------------------------------------------
# table reader
# ---------------------------------------------------------------------------

_TABLES = ("scene", "sample", "sample_data", "calibrated_sensor", "sensor",
           "ego_pose", "sample_annotation", "instance", "category")


class NuScenesTables:
    """The nuScenes relational tables, loaded from `{root}/{version}/
    {table}.json` into token-keyed dicts with the joins the loader needs.
    Equivalent to the devkit's `NuScenes` minus map rasterization (ours
    lives in data/nuscenes_raster.py)."""

    def __init__(self, root: str, version: str = "v1.0-trainval"):
        self.root = Path(root)
        tdir = self.root / version
        if not tdir.exists():
            raise FileNotFoundError(
                f"nuScenes tables not found at {tdir} — set "
                f"NUSCENES_DATA_DIR / dataset_dir to the dataroot")
        self.t: Dict[str, Dict[str, dict]] = {}
        for name in _TABLES:
            path = tdir / f"{name}.json"
            rows = json.loads(path.read_text()) if path.exists() else []
            self.t[name] = {r["token"]: r for r in rows}

        # sample -> {channel: keyframe sample_data row}
        self.sample_data_by_sample: Dict[str, Dict[str, dict]] = {}
        for sd in self.t["sample_data"].values():
            if not sd.get("is_key_frame", False):
                continue
            sensor = self.t["sensor"][
                self.t["calibrated_sensor"][sd["calibrated_sensor_token"]]
                ["sensor_token"]]
            self.sample_data_by_sample.setdefault(
                sd["sample_token"], {})[sensor["channel"]] = sd
        # sample -> annotation rows
        self.anns_by_sample: Dict[str, List[dict]] = {}
        for a in self.t["sample_annotation"].values():
            self.anns_by_sample.setdefault(a["sample_token"], []).append(a)

    def category_name(self, ann: dict) -> str:
        inst = self.t["instance"][ann["instance_token"]]
        return self.t["category"][inst["category_token"]]["name"]

    def samples_in_scenes(self, scene_names) -> List[dict]:
        names = set(scene_names)
        keep = {tok for tok, s in self.t["scene"].items()
                if s["name"] in names}
        rows = [s for s in self.t["sample"].values()
                if s["scene_token"] in keep]
        rows.sort(key=lambda s: (s["scene_token"], s["timestamp"]))
        return rows


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


class NuScenesDataset:
    """Synchronized 6-camera samples + on-the-fly 12-channel BEV raster."""

    def __init__(self, version: str = "v1.0-trainval",
                 dataset_dir: Optional[str] = None,
                 split: str = "val",
                 cam_res: Tuple[int, int] = (224, 400),
                 cameras: Sequence[str] = NUSCENES_CAMERAS,
                 normalize_cam_img: bool = True,
                 scene_names: Optional[Sequence[str]] = None, **_):
        root = dataset_dir or os.environ.get("NUSCENES_DATA_DIR", "")
        self.nusc = NuScenesTables(root, version)
        self.cameras = list(cameras)
        self.cam_res = cam_res
        self.normalize = normalize_cam_img

        if scene_names is None:
            scene_names = scene_split(split)
        self.samples = self.nusc.samples_in_scenes(scene_names)
        print(f"NuScenesDataset[{split}]: {len(self)} samples")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        import cv2

        nusc = self.nusc
        sample = self.samples[idx]
        data = nusc.sample_data_by_sample[sample["token"]]

        # the nuScenes extrinsics convention is the OPPOSITE of the
        # Argoverse one: E = cam_from_egocam @ egocam_from_world @
        # world_from_egolidarFLAT (yaw-only lidar frame), i.e. ego->cam
        # (nuscenes_helper.py:281-312 parse_sample_record) — NOT the
        # calibrated sensor's cam->ego transform
        egolidar = nusc.t["ego_pose"][data["LIDAR_TOP"]["ego_pose_token"]]
        world_from_egolidarflat = pose_flat(egolidar["rotation"],
                                            egolidar["translation"])

        imgs, Ks, Es = [], [], []
        for cam in self.cameras:
            sd = data[cam]
            cs = nusc.t["calibrated_sensor"][sd["calibrated_sensor_token"]]
            img = cv2.cvtColor(
                cv2.imread(str(nusc.root / sd["filename"])),
                cv2.COLOR_BGR2RGB)
            adjust = cg.CamIntrinsicAdjust(rescale_first=False)
            adjust.set_scale(self.cam_res[1] / img.shape[1],
                             self.cam_res[0] / img.shape[0])
            # PIL uint8 resize before /255 (reference resize->to_tensor
            # order; see camera_geometry.resize_bicubic_uint8)
            img = cg.resize_bicubic_uint8(img, self.cam_res)
            img01 = img.astype(np.float32) / 255.0
            imgs.append(cg.normalize_image(img01) if self.normalize
                        else img01)
            Ks.append(adjust.apply(np.asarray(cs["camera_intrinsic"])))
            egocam = nusc.t["ego_pose"][sd["ego_pose_token"]]
            cam_from_egocam = se3(cs["rotation"], cs["translation"],
                                  inv=True)
            egocam_from_world = se3(egocam["rotation"],
                                    egocam["translation"], inv=True)
            Es.append((cam_from_egocam @ egocam_from_world @
                       world_from_egolidarflat).astype(np.float32))

        # BEV raster from annotations around the ego pose — the
        # reference's raster frame is the FLAT (yaw-only) lidar pose
        # (parse_sample_record stores pose_inverse =
        # egolidarflat_from_world)
        pose_inv = pose_flat(egolidar["rotation"], egolidar["translation"],
                             inv=True)
        # class mapping per the reference's get_category_index
        # (token membership: 'vehicle.construction' -> construction,
        # 'human.pedestrian.adult' -> pedestrian)
        boxes_by_class: Dict[str, List[np.ndarray]] = {}
        for a in nusc.anns_by_sample.get(sample["token"], []):
            idx = nr.category_index(nusc.category_name(a))
            if idx is None:
                continue
            quad = nr.box_bottom_corners(
                a["translation"], a["size"], quat_yaw(a["rotation"]))
            boxes_by_class.setdefault(nr.DYNAMIC_CLASSES[idx],
                                      []).append(quad)
        dyn = nr.get_dynamic_layers(boxes_by_class, pose_inv)
        # map layers (lane/road_segment polygons + divider lines) need
        # the nuScenes map expansion; without it they are zero — the
        # CHANNEL ORDER is the reference CLASSES list either way
        static = np.zeros(dyn.shape[:2] + (len(nr.STATIC_CLASSES),),
                          np.float32)
        lines = np.zeros(dyn.shape[:2] + (len(nr.DIVIDER_CLASSES),),
                         np.float32)
        seg = np.concatenate([static, lines, dyn], axis=-1)

        K = np.stack(Ks)
        E = np.stack(Es)
        return {
            "image": np.stack(imgs),
            "segmentation": seg,
            "intrinsics": K,
            "extrinsics": E,
            "intrinsics_inv": np.linalg.inv(K.astype(np.float64)).astype(
                np.float32),
            "extrinsics_inv": np.linalg.inv(E.astype(np.float64)).astype(
                np.float32),
            "cam_name": list(self.cameras),
            "sample_token": sample["token"],
            "dataset": "nuscenes",
        }
