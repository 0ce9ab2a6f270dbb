"""nuScenes-style BEV raster builders (the 12-channel layout).

The port's copy of `bevgen_tpu/data/nuscenes_raster.py`: the same arrays
for the same inputs. Polygons, polylines and boxes in the global frame go
through the pose's inverse and the BEV view homography
(`models/geometry.py:get_view_matrix`) and are drawn with cv2, which is
imported inside the functions that draw (only when there is something to
draw), so importing this module pulls in no cv2.

Conventions of the reference: a 256x256 raster over an 80 m x 80 m window,
the ego at the centre, facing up.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from bevgen_torch.models.geometry import get_view_matrix

BEV = {"h": 256, "w": 256, "h_meters": 80.0, "w_meters": 80.0,
       "offset": 0.0}
VIEW = get_view_matrix(BEV["h"], BEV["w"], BEV["h_meters"], BEV["w_meters"],
                       BEV["offset"])
# drop the z row when projecting homogeneous 3D points (reference S)
S = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)

# 12-channel nuScenes layout = the reference CLASSES list
# (nuscenes_helper.py:16-30): STATIC (map polygon layers) + DIVIDER
# (map line layers) + 8 DYNAMIC annotation classes, in this order
STATIC_CLASSES = ("lane", "road_segment")
DIVIDER_CLASSES = ("road_divider", "lane_divider")
DYNAMIC_CLASSES = ("car", "truck", "bus", "trailer", "construction",
                   "pedestrian", "motorcycle", "bicycle")


def category_index(name: str, categories=DYNAMIC_CLASSES):
    """Annotation category -> class index by dotted-token membership
    (nuscenes_helper.py:402-411 get_category_index:
    'human.pedestrian.adult' -> pedestrian, 'vehicle.construction' ->
    construction). None when no token matches."""
    tokens = name.split(".")
    for i, category in enumerate(categories):
        if category in tokens:
            return i
    return None


def global_to_bev(points_global: np.ndarray,
                  pose_inverse: np.ndarray) -> np.ndarray:
    """(n, 3) global points -> (n, 2) int BEV pixels via pose^-1 and the
    view homography (convert_to_box, nuscenes_helper.py:373-400)."""
    p = np.asarray(points_global, np.float64)
    p = np.concatenate([p, np.ones((len(p), 1))], axis=1).T     # (4, n)
    out = VIEW @ S @ np.asarray(pose_inverse, np.float64) @ p   # (3, n)
    return np.round(out[:2] / out[2:3]).astype(np.int32).T


def raster_polygons(polygons_px: Sequence[np.ndarray],
                    shape=(256, 256)) -> np.ndarray:
    img = np.zeros(shape, np.uint8)
    polys = [np.asarray(p, np.int32).reshape(-1, 2) for p in polygons_px
             if len(p) >= 3]
    if polys:
        import cv2
        cv2.fillPoly(img, polys, 1, cv2.LINE_8)
    return img


def raster_lines(lines_px: Sequence[np.ndarray], shape=(256, 256),
                 thickness: int = 2) -> np.ndarray:
    img = np.zeros(shape, np.uint8)
    for line in lines_px:
        pts = np.asarray(line, np.int32).reshape(-1, 2)
        if len(pts) >= 2:
            import cv2
            cv2.polylines(img, [pts], False, 1, thickness)
    return img


def get_static_layers(polygons_by_class: Dict[str, List[np.ndarray]],
                      pose_inverse: np.ndarray,
                      classes: Sequence[str] = STATIC_CLASSES) -> np.ndarray:
    """(h, w, len(classes)) from global-frame polygons
    (nuscenes_helper.py get_static_layers)."""
    layers = []
    for cls in classes:
        polys = [global_to_bev(p, pose_inverse)
                 for p in polygons_by_class.get(cls, [])]
        layers.append(raster_polygons(polys))
    return np.stack(layers, axis=-1).astype(np.float32)


def get_line_layers(lines_by_class: Dict[str, List[np.ndarray]],
                    pose_inverse: np.ndarray,
                    classes: Sequence[str] = DIVIDER_CLASSES,
                    thickness: int = 2) -> np.ndarray:
    layers = []
    for cls in classes:
        lines = [global_to_bev(l, pose_inverse)
                 for l in lines_by_class.get(cls, [])]
        layers.append(raster_lines(lines, thickness=thickness))
    return np.stack(layers, axis=-1).astype(np.float32)


def box_bottom_corners(translation, size, yaw) -> np.ndarray:
    """(4, 3) global bottom corners of a box (w, l, h sizing and corner
    order matching nuscenes data_classes.Box.bottom_corners)."""
    w, l, h = size
    x = np.array([l, l, -l, -l]) / 2.0
    y = np.array([w, -w, -w, w]) / 2.0
    z = np.full(4, -h / 2.0)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pts = R @ np.stack([x, y, z])
    return pts.T + np.asarray(translation)


def get_dynamic_layers(boxes_by_class: Dict[str, List[np.ndarray]],
                       pose_inverse: np.ndarray,
                       classes: Sequence[str] = DYNAMIC_CLASSES) -> np.ndarray:
    """(h, w, len(classes)) box-footprint channels; boxes are (4, 3)
    global bottom-corner quads."""
    layers = []
    for cls in classes:
        quads = [global_to_bev(q, pose_inverse)
                 for q in boxes_by_class.get(cls, [])]
        layers.append(raster_polygons(quads))
    return np.stack(layers, axis=-1).astype(np.float32)


def get_dynamic_objects(boxes_global: Sequence[np.ndarray],
                        pose_inverse: np.ndarray,
                        shape=(256, 256)) -> np.ndarray:
    """Center-ness regression targets (h, w, 8):
    [segmentation, center_score, center_offset(2), orientation(2),
    half-extents(2)] (nuscenes_helper.py:327-371)."""
    h, w = shape
    segmentation = np.zeros((h, w), np.uint8)
    center_score = np.zeros((h, w), np.float32)
    center_offset = np.zeros((h, w, 2), np.float32)
    center_ohw = np.zeros((h, w, 4), np.float32)
    buf = np.zeros((h, w), np.uint8)
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1
                      ).astype(np.float32)
    for quad in boxes_global:
        px = global_to_bev(quad, pose_inverse).astype(np.float64)
        center = px.mean(0)
        front = (px[0] + px[1]) / 2.0
        left = (px[0] + px[3]) / 2.0
        buf.fill(0)
        import cv2
        cv2.fillPoly(buf, [px.round().astype(np.int32)], 1, cv2.LINE_8)
        mask = buf > 0
        if not mask.any():
            continue
        segmentation[mask] = 1
        off = (((center[None] - coords[mask]) / h) + 1) / 2
        center_offset[mask] = off
        center_score[mask] = np.exp(-(off ** 2).sum(-1))
        d = front - center
        center_ohw[mask, 0:2] = ((d / (np.linalg.norm(d) + 1e-6)) + 1) / 2
        center_ohw[mask, 2] = np.linalg.norm(front - center) / h
        center_ohw[mask, 3] = np.linalg.norm(left - center) / h
    return np.concatenate(
        [segmentation[..., None].astype(np.float32),
         center_score[..., None], center_offset, center_ohw], axis=-1)


def parse_pose(translation, rotation_matrix, inv: bool = False) -> np.ndarray:
    """4x4 pose from R, t (nuscenes_helper.py:278 / 222
    get_transformation_matrix)."""
    M = np.eye(4)
    R = np.asarray(rotation_matrix, np.float64)
    t = np.asarray(translation, np.float64)
    if inv:
        M[:3, :3] = R.T
        M[:3, 3] = R.T @ -t
    else:
        M[:3, :3] = R
        M[:3, 3] = t
    return M
