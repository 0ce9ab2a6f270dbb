"""BEV raster pre-generation CLI — the reference
scripts/argoverse_preprocess.py equivalent, devkit-free; the port's
counterpart of `bevgen_tpu/scripts/preprocess.py`.

  python -m bevgen_torch.scripts.preprocess dataset_dir=/data/av2/sensor \
      save_dir=/data/av2/bev_seg_full_11_14 split=val workers=8

Reads the AV2 on-disk format directly with pandas/json:
  <log>/annotations.feather                       cuboids
  <log>/city_SE3_egovehicle.feather               ego poses
  <log>/map/log_map_archive_*.json                vector map
and writes `<save_dir>/<split>/<log_id>/<lidar_ts>.npz` 7-channel
rasters (bevgen_torch.data.rasterize: cv2, or the native C++ core under
BEVGEN_NATIVE_RASTER=1). A host-only script: it needs pandas (and cv2 on
the default route), which the card's machine does not have, so it is held
on the CPU only. An unknown argument exits (the JAX script prints it and
goes on).
"""
from __future__ import annotations

import json
import multiprocessing as mp
import sys
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from bevgen_torch.data import rasterize
from bevgen_torch.data.argoverse import quat_to_rot
from bevgen_torch.scripts import cli


def load_map_archive(log_dir: Path) -> Dict:
    files = list((log_dir / "map").glob("log_map_archive_*.json"))
    if not files:
        return {}
    with open(files[0]) as f:
        return json.load(f)


def load_poses(log_dir: Path):
    import pandas as pd
    df = pd.read_feather(log_dir / "city_SE3_egovehicle.feather")
    return df.set_index("timestamp_ns")


def pose_at(poses, ts: int) -> Tuple[np.ndarray, np.ndarray]:
    row = poses.loc[ts]
    R = quat_to_rot(row["qw"], row["qx"], row["qy"], row["qz"])
    t = np.array([row["tx_m"], row["ty_m"], row["tz_m"]])
    return R, t


def cuboid_footprint(row) -> np.ndarray:
    """Ego-frame footprint quad of one annotation row (length/width/
    quaternion pose), matching the reference's use of the box's bottom
    corners (argoverse_preprocess.py:154)."""
    R = quat_to_rot(row["qw"], row["qx"], row["qy"], row["qz"])
    t = np.array([row["tx_m"], row["ty_m"], row["tz_m"]])
    l, w = row["length_m"] / 2.0, row["width_m"] / 2.0
    corners = np.array([[l, w, 0], [l, -w, 0], [-l, -w, 0], [-l, w, 0]])
    return (R @ corners.T).T + t


def polyline_points(obj) -> np.ndarray:
    return np.array([[p["x"], p["y"], p.get("z", 0.0)] for p in obj])


def process_log(log_dir: Path, save_dir: Path, split: str,
                overwrite: bool = False) -> int:
    import pandas as pd
    log_id = log_dir.name
    out_dir = save_dir / split / log_id
    lidar_dir = log_dir / "sensors" / "lidar"
    if not lidar_dir.exists():
        return 0
    timestamps = sorted(int(p.stem) for p in lidar_dir.glob("*.feather"))
    if not timestamps:
        return 0
    ann_path = log_dir / "annotations.feather"
    annotations = pd.read_feather(ann_path) if ann_path.exists() else None
    poses = load_poses(log_dir)
    amap = load_map_archive(log_dir)

    drivable_city = [polyline_points(da["area_boundary"])
                     for da in amap.get("drivable_areas", {}).values()]
    ped_city = []
    for px in amap.get("pedestrian_crossings", {}).values():
        e1 = polyline_points(px["edge1"])
        e2 = polyline_points(px["edge2"])
        ped_city.append(np.concatenate([e1, e2[::-1]]))
    lanes_city: List[np.ndarray] = []
    stops_city: List[np.ndarray] = []
    for seg in amap.get("lane_segments", {}).values():
        left = polyline_points(seg["left_lane_boundary"])
        right = polyline_points(seg["right_lane_boundary"])
        lanes_city.extend([left, right])
        if seg.get("is_intersection"):
            stops_city.append(np.stack([right[0], left[0]]))

    n = 0
    for ts in timestamps:
        out_file = out_dir / f"{ts}.npz"
        if out_file.exists() and not overwrite:
            continue
        try:
            R, t = pose_at(poses, ts)
        except KeyError:
            continue
        to_ego = lambda pts: rasterize.city_to_ego(pts, R, t)
        cuboids = []
        if annotations is not None:
            rows = annotations[annotations.timestamp_ns == ts]
            for _, row in rows.iterrows():
                cuboids.append((row["category"], cuboid_footprint(row)))
        layers = rasterize.rasterize_scene(
            drivable_polygons_ego=[to_ego(p) for p in drivable_city],
            cuboid_footprints_ego=cuboids,
            lane_boundaries_ego=[to_ego(p) for p in lanes_city],
            stoplines_ego=[to_ego(p) for p in stops_city],
            ped_crossing_polygons_ego=[to_ego(p) for p in ped_city],
        )
        out_dir.mkdir(parents=True, exist_ok=True)
        rasterize.save_bev_raster(out_file, layers)
        n += 1
    return n


def main(argv: Optional[List[str]] = None) -> int:
    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    dataset_dir = Path(args.pop("dataset_dir"))
    save_dir = Path(args.pop("save_dir"))
    split = args.pop("split", "val")
    workers = int(args.pop("workers", 1))
    overwrite = args.pop("overwrite", "false").lower() == "true"
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")

    split_dir = dataset_dir / split
    logs = sorted(p for p in split_dir.iterdir() if p.is_dir())
    print(f"{len(logs)} logs in {split_dir}")
    worker = partial(process_log, save_dir=save_dir, split=split,
                     overwrite=overwrite)
    if workers > 1:
        with mp.get_context("spawn").Pool(workers) as pool:
            counts = pool.map(worker, logs)
    else:
        counts = [worker(l) for l in logs]
    print(f"wrote {sum(counts)} rasters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
