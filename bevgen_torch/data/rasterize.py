"""BEV semantic rasters: their geometry, categories and npz files.

The part of `bevgen_tpu/data/rasterize.py` that the port's data path uses:
the reference's offline BEV rasters (scripts/argoverse_preprocess.py:
43-232) are an 80m x 80m ego-centered window at 256x256, 0.3125 m/px, with
7 channels

    [VEHICLE, LARGE_VEHICLE, PEDESTRIAN, OTHER,
     drivable, lane_lines, stopline+ped_crossing]

flipped up-down so the ego points "up" (README.md:97-101). The dataset
reads them with `load_bev_raster`. Drawing rasters from map geometry
(`rasterize_scene` and its polygon and polyline fills) is not ported: no
entry point of the port preprocesses a tree yet.
"""
from __future__ import annotations

import numpy as np

# raster geometry (argoverse_preprocess.py:83-87)
IMG_RANGE_M = 40.0
RESOLUTION_PX = 256
METERS_PER_PIXEL = (2 * IMG_RANGE_M) / RESOLUTION_PX
EXTENTS = (-IMG_RANGE_M, -IMG_RANGE_M, IMG_RANGE_M, IMG_RANGE_M)

# fixed ego->"BEV cam" rotation (argoverse_preprocess.py:140):
# cam x = ego -y (left becomes right), cam y = ego -z, cam z = ego x.
EGO_R_CAM = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], dtype=np.float64)

# 4-class cuboid category mapping (argoverse_helper.py:20-51)
STANDARD_CATEGORIES = ("VEHICLE", "LARGE_VEHICLE", "PEDESTRIAN", "OTHER")
LARGE_VEHICLE_CATS = frozenset({
    "ARTICULATED_BUS", "BOX_TRUCK", "BUS", "LARGE_VEHICLE",
    "TRAFFIC_LIGHT_TRAILER", "TRUCK", "TRUCK_CAB", "VEHICULAR_TRAILER"})


def standard_category(raw: str) -> str:
    if raw == "REGULAR_VEHICLE":
        return "VEHICLE"
    if raw in LARGE_VEHICLE_CATS:
        return "LARGE_VEHICLE"
    if raw == "PEDESTRIAN":
        return "PEDESTRIAN"
    return "OTHER"


def ego_to_bev_px(points_ego: np.ndarray) -> np.ndarray:
    """Ego-frame 3D points -> integer BEV pixel coords (col-major x/z of
    the BEV cam frame; argoverse_preprocess.py:43-50)."""
    cam = (EGO_R_CAM.T @ np.asarray(points_ego, np.float64).T).T  # cam<-ego
    xy = cam[:, [0, 2]]
    px = (xy - np.array(EXTENTS[:2])) / METERS_PER_PIXEL
    return np.ascontiguousarray(np.round(px)).astype(np.int32)


def save_bev_raster(path, layers: np.ndarray):
    """npz layout matching the reference (`np.savez_compressed(f, arr)`
    read back via `next(iter(npz.values()))`)."""
    np.savez_compressed(path, layers)


def load_bev_raster(path) -> np.ndarray:
    with np.load(path) as f:
        return next(iter(f.values())).astype(np.float32)
