"""Argoverse 2 multi-camera dataset — standalone, no av2 devkit.

The port's copy of `bevgen_tpu/data/argoverse.py`: the same samples, key
for key, for the same tree and seed. pandas and cv2 are imported inside
the functions that need them, so importing this module pulls in neither.

Re-designed data layer with the reference `Argoverse` dataset's
capabilities (bev_utils/argoverse.py:40-484): synchronized multi-camera
samples + pre-generated BEV rasters + camera calibration, with square
crops, normalization and intrinsics adjustment.

Unlike the reference (which forks the av2 devkit's SensorDataloader),
this reads the AV2 on-disk format directly — sensor jpgs, calibration
feathers (`calibration/intrinsics.feather`,
`calibration/egovehicle_SE3_sensor.feather`) and the pre-generated BEV
npz tree — with pandas/numpy only. Expected layout:

  <root>/sensor/<split>/<log_id>/sensors/cameras/<cam>/<ts>.jpg
  <root>/sensor/<split>/<log_id>/sensors/lidar/<ts>.feather
  <root>/sensor/<split>/<log_id>/calibration/*.feather
  <root>/<bev_dir>/<split>/<log_id>/<lidar_ts>.npz     (rasterize.py)

Batch dict schema matches the reference (argoverse.py:296-305):
image [cam,h,w,3] normalized, segmentation [256,256,7],
intrinsics(_inv) [cam,3,3], extrinsics(_inv) [cam,4,4], cam_name,
sample_token, dataset.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bevgen_torch.data import camera_geometry as cg
from bevgen_torch.data import rasterize, sync

SPLITS = {"train": 0, "val": 1, "test": 2}


def quat_to_rot(qw, qx, qy, qz) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation matrix."""
    q = np.array([qw, qx, qy, qz], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def load_calibration(log_dir: Path) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-camera K (3,3) and ego_SE3_cam (4,4) from the AV2 calibration
    feathers."""
    import pandas as pd
    intr = pd.read_feather(log_dir / "calibration" / "intrinsics.feather")
    extr = pd.read_feather(log_dir / "calibration" /
                           "egovehicle_SE3_sensor.feather")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for _, row in intr.iterrows():
        K = np.array([[row["fx_px"], 0, row["cx_px"]],
                      [0, row["fy_px"], row["cy_px"]],
                      [0, 0, 1]], np.float64)
        out[row["sensor_name"]] = {
            "K": K,
            "width": int(row.get("width_px", 0)),
            "height": int(row.get("height_px", 0)),
        }
    for _, row in extr.iterrows():
        name = row["sensor_name"]
        if name not in out:
            out[name] = {}
        E = np.eye(4)
        E[:3, :3] = quat_to_rot(row["qw"], row["qx"], row["qy"], row["qz"])
        E[:3, 3] = [row["tx_m"], row["ty_m"], row["tz_m"]]
        out[name]["ego_SE3_cam"] = E
    return out


def load_image(path: Path) -> np.ndarray:
    import cv2
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class ArgoverseDataset:
    """Synchronized multi-camera + BEV samples (reference
    `Argoverse(multi_camera=True)`)."""

    def __init__(
        self,
        split: int | str = "val",
        dataset_dir: Optional[str] = None,
        bev_dir_name: str = "bev_seg_full_11_14",
        cam_res: Tuple[int, int] = (256, 256),
        specific_cameras: Optional[Sequence[str]] = None,
        square_image: bool = True,
        normalize_cam_img: bool = True,
        specific_frames: Optional[str] = None,
        eval_generate: Optional[str] = None,
        cache_dir: Optional[str] = None,
        fake_load: bool = False,
        mini_dataset: Optional[int] = None,
        augment_cam_img: bool = False,
        augment_bev_img: bool = False,
        multi_camera: bool = True,
        seed: int = 0,
        **_,
    ):
        if isinstance(split, int):
            split = {v: k for k, v in SPLITS.items()}[split]
        self.split = split
        self.root = Path(dataset_dir or
                         os.environ.get("ARGOVERSE_DATA_DIR", ""))
        self.sensor_dir = self.root / "sensor" / split
        self.bev_dir = self.root / bev_dir_name / split
        self.cam_res = cam_res
        self.cameras = list(specific_cameras or
                            ("ring_front_left", "ring_front_center",
                             "ring_front_right"))
        self.square_image = square_image
        self.normalize = normalize_cam_img
        self.fake_load = fake_load
        self.augment_cam = augment_cam_img
        self.augment_bev = augment_bev_img
        self.multi_camera = multi_camera
        # shared-parameter jitter needs one draw per sample; loader worker
        # threads share this generator behind a lock
        import threading
        self._aug_rng = np.random.default_rng(seed)
        self._aug_lock = threading.Lock()

        files: List[Path] = []
        if self.sensor_dir.exists():
            for log_dir in sorted(self.sensor_dir.iterdir()):
                cams = log_dir / "sensors" / "cameras"
                lidar = log_dir / "sensors" / "lidar"
                for cam in self.cameras:
                    if (cams / cam).exists():
                        files.extend(sorted((cams / cam).glob("*.jpg")))
                if lidar.exists():
                    files.extend(sorted(lidar.glob("*.feather")))
        records = sync.build_sensor_records(files, split)
        if records.empty and not fake_load:
            raise FileNotFoundError(
                f"no AV2 sensor files under {self.sensor_dir} — set "
                "ARGOVERSE_DATA_DIR (or dataset_dir=) to a sensor-split "
                "root, or drive with the fake-batch fixture (fake=N)")
        if multi_camera:
            cache = (Path(cache_dir) / f"{split}_sync.feather"
                     if cache_dir else None)
            table = sync.load_or_build_sync_cache(cache, records, "lidar",
                                                  self.cameras)
            table = sync.filter_complete(table, self.cameras)
        else:
            # single-camera per-frame records: stage 1 trains on ALL
            # frames, BEV matched through the nearest lidar sweep
            # (argoverse.py:307-333)
            table = sync.per_frame_records(records, self.cameras)

        # only keep sweeps with a pre-generated BEV raster
        if self.bev_dir.exists():
            lidar_of = (lambda r: r.timestamp_ns) if multi_camera else (
                lambda r: r.lidar)
            has_bev = [
                (self.bev_dir / r.log_id / f"{lidar_of(r)}.npz").exists()
                for r in table.itertuples()]
            table = table[np.asarray(has_bev, bool)].reset_index(drop=True)

        if specific_frames:
            with open(specific_frames, "rb") as f:
                wanted = {(s, l, int(t)) for s, l, t in pickle.load(f)}
            keep = [(r.split, r.log_id, r.timestamp_ns) in wanted
                    for r in table.itertuples()]
            table = table[np.asarray(keep, bool)].reset_index(drop=True)

        if eval_generate:
            # resume-awareness: skip samples already generated
            # (README.md:122) — output tree sample/<token>/...
            done = set()
            gen_dir = Path(eval_generate) / "sample"
            if gen_dir.exists():
                done = {p.name for p in gen_dir.iterdir()}
            keep = [f"{r.log_id}_{r.timestamp_ns}" not in done
                    for r in table.itertuples()]
            table = table[np.asarray(keep, bool)].reset_index(drop=True)

        if mini_dataset:
            table = table.iloc[:mini_dataset].reset_index(drop=True)

        self.table = table
        self._calib_cache: Dict[str, Dict] = {}
        import threading
        self._calib_lock = threading.Lock()
        print(f"ArgoverseDataset[{split}]: {len(self)} samples")

    def __len__(self):
        return len(self.table)

    def calibration(self, log_id: str) -> Dict:
        # loader worker threads share this cache
        with self._calib_lock:
            if log_id not in self._calib_cache:
                self._calib_cache[log_id] = load_calibration(
                    self.sensor_dir / log_id)
            return self._calib_cache[log_id]

    def _sample_rng(self) -> np.random.Generator:
        """Per-sample child generator (thread-safe draw)."""
        with self._aug_lock:
            return self._aug_rng.spawn(1)[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if not self.multi_camera:
            return self._get_single(idx)
        row = self.table.iloc[idx]
        log_id, lidar_ts = row.log_id, int(row.timestamp_ns)
        token = f"{log_id}_{lidar_ts}"
        if self.fake_load:
            return {"sample_token": token}

        rng = self._sample_rng()
        # jitter parameters are drawn ONCE and shared by every camera in
        # the rig (argoverse.py:271)
        color = cg.color_jitter_params(rng) if self.augment_cam else None

        seg = rasterize.load_bev_raster(
            self.bev_dir / log_id / f"{lidar_ts}.npz")
        if self.augment_bev:
            seg = cg.augment_bev(rng, seg)

        calib = self.calibration(log_id)
        imgs, Ks, Es = [], [], []
        for cam in self.cameras:
            ts = int(row[cam])
            img = load_image(self.sensor_dir / log_id / "sensors" /
                             "cameras" / cam / f"{ts}.jpg")
            # reference quirk (kept for checkpoint fidelity): the square
            # crop is NOT folded into the intrinsics — only the resize
            # scale and the AUGMENTATION crop are (argoverse.py:186-217,
            # 220-226: fresh NusceneCamGeometry per camera)
            adjust = cg.CamIntrinsicAdjust(rescale_first=False)
            if self.square_image:
                if cam == "ring_front_center":
                    # on-disk center image is portrait (2048x1550); the
                    # reference's transpose/un-transpose dance nets out
                    # to cropping rows off the top (argoverse.py:267,280)
                    img = img[(img.shape[0] - img.shape[1]):]
                else:
                    img = cg.square_crop(img, cam)
            elif cam == "ring_front_center":
                # NON-square (rect) mode keeps the reference's
                # load-time transpose (argoverse.py:267): the portrait
                # center image is served landscape to process_img
                img = np.ascontiguousarray(img.transpose(1, 0, 2))
            if self.augment_cam:
                # jitter runs in float here (the reference jitters the
                # uint8 PIL image; training-time randomness, not a
                # parity surface)
                img01 = cg.apply_color_jitter(
                    img.astype(np.float32) / 255.0, color)
                # crop position/scale is drawn PER CAMERA
                # (argoverse.py:207-213, scale_max 0.1) and folded into K
                top, left, nh, nw = cg.random_crop_params(
                    rng, img01.shape[0], img01.shape[1], 0.1)
                img01 = img01[top:top + nh, left:left + nw]
                adjust.set_scale(self.cam_res[1] / nw, self.cam_res[0] / nh)
                adjust.set_crop(top, left)
                img01 = np.clip(cg.resize_bicubic(img01, self.cam_res),
                                0.0, 1.0)
            else:
                # eval/parity path: PIL uint8 resize BEFORE /255, exactly
                # like the reference's PIL resize -> to_tensor
                # (argoverse.py:214-216)
                adjust.set_scale(self.cam_res[1] / img.shape[1],
                                 self.cam_res[0] / img.shape[0])
                img01 = cg.resize_bicubic_uint8(
                    img, self.cam_res).astype(np.float32) / 255.0
            imgs.append(cg.normalize_image(img01) if self.normalize else img01)
            Ks.append(adjust.apply(calib[cam]["K"]))
            Es.append(calib[cam]["ego_SE3_cam"].astype(np.float32))

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
            "sample_token": token,
            "dataset": "argoverse",
        }

    def _get_single(self, idx: int) -> Dict[str, np.ndarray]:
        """Single-camera per-frame sample (stage-1 training mode,
        argoverse.py:307-333): one camera frame + the BEV raster of its
        nearest lidar sweep."""
        row = self.table.iloc[idx]
        log_id, cam = row.log_id, row.sensor_name
        ts, lidar_ts = int(row.timestamp_ns), int(row.lidar)
        token = f"{log_id}_{cam}_{ts}"
        if self.fake_load:
            return {"sample_token": token}

        rng = self._sample_rng()
        seg = rasterize.load_bev_raster(
            self.bev_dir / log_id / f"{lidar_ts}.npz")
        if self.augment_bev:
            # single-camera BEV augmentation is stronger
            # (argoverse.py:164-165: shift/scale 0.075, rotate 10deg)
            seg = cg.augment_bev(rng, seg, shift_limit=0.075,
                                 scale_limit=0.075, rotate_limit=10.0,
                                 p_flip=0.0)

        img = load_image(self.sensor_dir / log_id / "sensors" /
                         "cameras" / cam / f"{ts}.jpg")
        if cam == "ring_front_center":
            img = img.transpose(1, 0, 2)   # portrait -> landscape (:315)
        if self.augment_cam:
            # crop augmentation, scale_max 0.25 (:208), + random hflip
            # (:151 RandomHorizontalFlip) — both exact on uint8
            top, left, nh, nw = cg.random_crop_params(
                rng, img.shape[0], img.shape[1], 0.25)
            img = img[top:top + nh, left:left + nw]
            if rng.uniform() < 0.5:
                img = img[:, ::-1]
        # PIL uint8 resize then /255, matching the reference's PIL
        # resize -> to_tensor order (argoverse.py:214-216)
        img01 = cg.resize_bicubic_uint8(
            img, self.cam_res).astype(np.float32) / 255.0
        img01 = cg.normalize_image(img01) if self.normalize else img01
        return {
            "image": img01[None],
            "segmentation": seg,
            "cam_name": [cam],
            "sample_token": token,
            "dataset": "argoverse",
        }

    def save_cam_data(self, path: str):
        """Persist one sample's rig (the reference's
        `pretrained/cam_data_*.pt` artifact, argoverse.py:355) as npz."""
        b = self[0]
        np.savez(path, intrinsics=b["intrinsics"][None],
                 extrinsics=b["extrinsics"][None])
