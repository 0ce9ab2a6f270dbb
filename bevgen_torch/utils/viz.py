"""BEV palette rendering + composite camera/BEV figures.

The port's copy of `bevgen_tpu/utils/viz.py`, with PIL imported inside
the functions that draw.
Reference: bev_utils/visualize.py (viz_bev :67 — 7-class Argoverse
channel reorder, priority argmax + alpha blend against light grey;
argoverse_camera_bev_grid :250, camera_bev_grid :200).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from bevgen_torch.utils.image import Im

# palettes (visualize.py:27-55)
ARGOVERSE_COLORS = {
    "driveable_area": (110, 110, 110),
    "lane_divider": (130, 130, 130),
    "ped_xing": (255, 200, 0),
    "pedestrian": (0, 0, 230),
    "vehicle": (255, 158, 0),
    "large_vehicle": (255, 99, 71),
    "other": (255, 127, 80),
    "nothing": (200, 200, 200),
}

# display order & source-channel permutation (visualize.py:86-87):
# raster channels [veh, large_veh, ped, other, drivable, lanes, stop+
# ped_xing] are permuted by [4,5,6,3,1,0,2] into the class list below —
# including the reference's quirk of pairing channel 1 (large_vehicle)
# with the "pedestrian" color slot and channel 2 (pedestrian) with
# "large_vehicle"; kept bit-for-bit so rendered BEVs match.
_ARGO_CLASSES = ["driveable_area", "lane_divider", "ped_xing", "other",
                 "pedestrian", "vehicle", "large_vehicle"]
_ARGO_PERM = [4, 5, 6, 3, 1, 0, 2]


def viz_bev(bev: np.ndarray, dataset: str = "argoverse") -> Im:
    """(h, w, 7) or (7, h, w) float [0,1] raster -> RGB Im."""
    bev = np.asarray(bev)
    if bev.ndim == 3 and bev.shape[1] == bev.shape[2] and bev.shape[0] < bev.shape[1]:
        bev = bev.transpose(1, 2, 0)
    bev = np.clip(bev.astype(np.float32), 0.0, 1.0)
    assert dataset == "argoverse", dataset
    bev = bev[..., _ARGO_PERM]
    colors = np.array([ARGOVERSE_COLORS[c] for c in _ARGO_CLASSES],
                      np.uint8)
    h, w, c = bev.shape
    eps = (1e-5 * np.arange(c))[None, None]
    idx = (bev + eps).argmax(axis=-1)
    val = np.take_along_axis(bev, idx[..., None], -1)
    empty = np.uint8(ARGOVERSE_COLORS["nothing"])[None, None]
    out = (val * colors[idx]) + ((1 - val) * empty)
    return Im(out.astype(np.uint8))


def _ego_marker(bev_img, half_w: int = 4, half_h: int = 8):
    from PIL import ImageDraw
    d = ImageDraw.Draw(bev_img)
    W, H = bev_img.size
    d.rectangle((W // 2 - half_w, H // 2 - half_h,
                 W // 2 + half_w, H // 2 + half_h), fill="#00FF11")
    return bev_img


def argoverse_camera_bev_grid(images: Dict[str, np.ndarray],
                              bev: Optional[np.ndarray] = None,
                              add_car: bool = True) -> Im:
    """BEV panel + front cameras side by side (visualize.py:250-296)."""
    from PIL import Image
    pil = {k: Im(v).pil for k, v in images.items()}
    w0, h0 = next(iter(pil.values())).size
    pad = 5
    height = h0
    width = len(pil) * w0 + height + 4 * pad
    dst = Image.new("RGB", (width, height), (0, 0, 0))
    bev_w = 0
    if bev is not None:
        bev_img = viz_bev(bev).pil.resize((height, height))
        if add_car:
            bev_img = _ego_marker(bev_img)
        dst.paste(bev_img, (0, 0))
        bev_w = height
    order3 = ["ring_front_left", "ring_front_center", "ring_front_right"]
    order5 = ["ring_side_left", "ring_front_left", "ring_front_center",
              "ring_front_right", "ring_side_right"]
    order = order3 if len(pil) == 3 else (
        order5 if len(pil) == 5 else list(pil))
    for i, name in enumerate(n for n in order if n in pil):
        dst.paste(pil[name], (bev_w + i * w0 + (i + 1) * pad, 0))
    return Im(dst)


def scene_figure(gen_images: np.ndarray, segmentation: np.ndarray,
                 cam_names, gt_images: Optional[np.ndarray] = None) -> Im:
    """One sample's composite figure: generated row (+ GT row)."""
    imgs = {str(n): gen_images[i] for i, n in enumerate(cam_names)}
    top = argoverse_camera_bev_grid(imgs, segmentation).np
    if gt_images is None:
        return Im(top)
    gt = {str(n): gt_images[i] for i, n in enumerate(cam_names)}
    bottom = argoverse_camera_bev_grid(gt, segmentation).np
    return Im(np.concatenate([top, bottom], axis=0))
