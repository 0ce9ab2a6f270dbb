"""BEV semantic rasterization: geometry, categories, drawing and npz files.

The port's copy of `bevgen_tpu/data/rasterize.py`: the reference's offline
BEV rasters (scripts/argoverse_preprocess.py:43-232) are an 80m x 80m
ego-centered window at 256x256, 0.3125 m/px, with 7 channels

    [VEHICLE, LARGE_VEHICLE, PEDESTRIAN, OTHER,
     drivable, lane_lines, stopline+ped_crossing]

flipped up-down so the ego points "up" (README.md:97-101). The dataset
reads them with `load_bev_raster`; `scripts/preprocess.py` and the scene
editor (`scripts/edit_scene.py`, `scripts/edit_server.py`) draw them with
`rasterize_scene`.

Two routes draw the polygon fills and polylines, as in the JAX module: cv2
(the default) and the native C++ core (`bevgen_torch/native.py`) under
`BEVGEN_NATIVE_RASTER=1`. No route hides another, where the JAX module
falls back quietly: with the native core asked for and its build failed
the drawing raises with the compiler's output, and on the cv2 route
without cv2 it raises ImportError naming both routes (JAX draws an empty
raster). cv2 is imported only when its route draws.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence, Tuple

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


def city_to_ego(points_city: np.ndarray, city_R_ego: np.ndarray,
                city_t_ego: np.ndarray) -> np.ndarray:
    """Invert a city_SE3_ego pose: p_ego = R^T (p_city - t)."""
    p = np.asarray(points_city, np.float64) - np.asarray(city_t_ego)
    return (np.asarray(city_R_ego).T @ p.T).T


def _use_native() -> bool:
    return os.environ.get("BEVGEN_NATIVE_RASTER") == "1"


def _require_cv2():
    try:
        import cv2
    except ImportError:
        raise ImportError(
            "drawing BEV rasters needs cv2 (the default route) or the native "
            "C++ core (BEVGEN_NATIVE_RASTER=1: bevgen_torch/native.py, built "
            "with g++ at first use); cv2 is not installed") from None
    return cv2


def fill_polygons(polygons: Iterable[np.ndarray],
                  shape: Tuple[int, int] = (RESOLUTION_PX, RESOLUTION_PX)
                  ) -> np.ndarray:
    """Binary mask from int pixel polygons (av2 raster_utils
    get_mask_from_polygons equivalent): cv2.fillPoly, or the native core
    under BEVGEN_NATIVE_RASTER=1."""
    polys = [np.asarray(p, np.int32).reshape(-1, 2) for p in polygons]
    polys = [p for p in polys if len(p) >= 3]
    if _use_native():
        from bevgen_torch import native
        return native.fill_polygons(polys, shape)
    cv2 = _require_cv2()
    img = np.zeros(shape, dtype=np.uint8)
    if polys:
        cv2.fillPoly(img, polys, 1)
    return img


def draw_polylines(polylines: Iterable[np.ndarray],
                   shape: Tuple[int, int] = (RESOLUTION_PX, RESOLUTION_PX),
                   thickness: int = 1) -> np.ndarray:
    """Binary mask of polylines (av2 draw_visible_polyline_segments
    equivalent): cv2.polylines, or the native core's 1-px Bresenham lines
    under BEVGEN_NATIVE_RASTER=1 (a thicker line takes cv2 on either)."""
    lines = [np.asarray(l, np.int32).reshape(-1, 2) for l in polylines]
    lines = [l for l in lines if len(l) >= 2]
    if thickness == 1 and _use_native():
        from bevgen_torch import native
        return native.draw_polylines(lines, shape)
    cv2 = _require_cv2()
    img = np.zeros(shape, dtype=np.uint8)
    for pts in lines:
        cv2.polylines(img, [pts], isClosed=False, color=1,
                      thickness=thickness)
    return img


def rasterize_scene(
    drivable_polygons_ego: Sequence[np.ndarray],
    cuboid_footprints_ego: Sequence[Tuple[str, np.ndarray]],
    lane_boundaries_ego: Sequence[np.ndarray],
    stoplines_ego: Sequence[np.ndarray],
    ped_crossing_polygons_ego: Sequence[np.ndarray],
    resolution: int = RESOLUTION_PX,
) -> np.ndarray:
    """Produce the 7-channel BEV raster (resolution, resolution, 7)
    float32 in the reference channel order, flipped up-down
    (argoverse_preprocess.py:143-208).

    cuboid_footprints_ego: (raw_category_name, (4, 3) footprint quad in
    ego frame) per annotation.
    """
    shape = (resolution, resolution)

    drivable = fill_polygons(
        [ego_to_bev_px(p) for p in drivable_polygons_ego], shape)

    by_cat: Dict[str, List[np.ndarray]] = {c: [] for c in STANDARD_CATEGORIES}
    for raw_cat, quad in cuboid_footprints_ego:
        by_cat[standard_category(raw_cat)].append(ego_to_bev_px(quad))
    cat_imgs = [fill_polygons(by_cat[c], shape) for c in STANDARD_CATEGORIES]

    lanes = draw_polylines([ego_to_bev_px(l) for l in lane_boundaries_ego],
                           shape)
    stop = draw_polylines([ego_to_bev_px(s) for s in stoplines_ego], shape)
    ped = fill_polygons([ego_to_bev_px(p) for p in ped_crossing_polygons_ego],
                        shape)
    stop_ped = np.logical_or(stop, ped).astype(np.uint8)

    layers = np.stack([*cat_imgs, drivable, lanes, stop_ped], axis=-1)
    return np.flipud(layers).astype(np.float32)


def save_bev_raster(path, layers: np.ndarray):
    """npz layout matching the reference (`np.savez_compressed(f, arr)`
    read back via `next(iter(npz.values()))`)."""
    np.savez_compressed(path, layers)


def load_bev_raster(path) -> np.ndarray:
    with np.load(path) as f:
        return next(iter(f.values())).astype(np.float32)
