"""Cross-camera overlap consistency metric.

Port of `bevgen_tpu/metrics/consistency.py` (the reference's
scripts/metrics_consistency_sift.py and metrics_consistency_sift_argo.py):
match features in the 50-px adjacent-edge windows of neighbouring cameras
and compare summed match confidence between ground-truth and generated
imagery, with MAGSAC fundamental-matrix inliers.

Two matchers, as in the JAX package:

  * LoFTR (`metrics/loftr.py`), engaged when converted weights exist:
    point ``BEVGEN_LOFTR_WEIGHTS`` at the npz that
    ``loftr.convert_loftr_weights`` writes; the numbers are then those of
    the paper's protocol;
  * SIFT + Lowe ratio test + USAC_MAGSAC, the weight-less classical
    fallback measuring the same quantity.

cv2 is imported inside the functions that use it (grayscale conversion,
MAGSAC, SIFT).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

EDGE_PX = 50  # overlap window width (metrics_consistency_sift.py)

# adjacent (left_cam, right_cam) pairs: right edge of A overlaps left
# edge of B
ARGOVERSE_PAIRS = (
    ("ring_front_left", "ring_front_center"),
    ("ring_front_center", "ring_front_right"),
)
NUSCENES_PAIRS = (
    ("CAM_FRONT_LEFT", "CAM_FRONT"),
    ("CAM_FRONT", "CAM_FRONT_RIGHT"),
)


def _to_gray_u8(img01: np.ndarray) -> np.ndarray:
    import cv2
    u8 = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)


def edge_windows(left_img: np.ndarray, right_img: np.ndarray,
                 edge_px: int = EDGE_PX) -> Tuple[np.ndarray, np.ndarray]:
    """(right strip of the left camera, left strip of the right camera)."""
    return left_img[:, -edge_px:], right_img[:, :edge_px]


# (weights path, device) -> the LoFTR matcher built from them
_LOFTR_MATCHERS: Dict[Tuple[str, str], Callable] = {}


def get_matcher(device: Union[str, torch.device] = "cuda"
                ) -> Optional[Callable]:
    """The LoFTR matcher on `device` when weights are available, else None
    (SIFT, which runs on the host).

    Weights come from ``BEVGEN_LOFTR_WEIGHTS`` (npz path). Cached per
    weights path and device: the weights are read once."""
    path = os.environ.get("BEVGEN_LOFTR_WEIGHTS", "")
    if not (path and os.path.exists(path)):
        return None
    from bevgen_torch.core.device import resolve_device
    key = (path, str(resolve_device(device)))
    if key not in _LOFTR_MATCHERS:
        from bevgen_torch.metrics.loftr import LoFTRMatcher
        _LOFTR_MATCHERS[key] = LoFTRMatcher.from_npz(path, device=key[1])
    return _LOFTR_MATCHERS[key]


def match_strips_loftr(a01: np.ndarray, b01: np.ndarray,
                       matcher: Callable) -> Dict[str, float]:
    """LoFTR matches between two overlap strips — the reference's
    protocol (metrics_consistency_sift.py:151-168): run the matcher on the
    grayscale windows, report match count and summed dual-softmax
    confidence; inliers via the MAGSAC fundamental-matrix check of the
    argo variant."""
    import cv2
    ga = _to_gray_u8(a01).astype(np.float32) / 255.0
    gb = _to_gray_u8(b01).astype(np.float32) / 255.0
    out = matcher(ga, gb)
    conf = out["confidence"]
    inliers = 0.0
    if len(conf) >= 8:
        try:
            _, mask = cv2.findFundamentalMat(
                out["keypoints0"], out["keypoints1"], cv2.USAC_MAGSAC,
                1.0, 0.999, 10000)
            inliers = float(mask.sum()) if mask is not None else 0.0
        except Exception:
            inliers = 0.0
    return {"num_matches": float(len(conf)),
            "confidence": float(conf.sum()), "inliers": inliers}


def match_strips(a01: np.ndarray, b01: np.ndarray,
                 ratio: float = 0.75,
                 matcher: Optional[Callable] = None) -> Dict[str, float]:
    """Match two overlap strips: LoFTR when a matcher is given or weights
    are present (see get_matcher), else SIFT + Lowe + MAGSAC."""
    matcher = matcher if matcher is not None else get_matcher()
    if matcher is not None:
        return match_strips_loftr(a01, b01, matcher)
    return match_strips_sift(a01, b01, ratio)


def match_strips_sift(a01: np.ndarray, b01: np.ndarray,
                      ratio: float = 0.75) -> Dict[str, float]:
    """SIFT matches + MAGSAC inliers between two overlap strips."""
    import cv2
    ga, gb = _to_gray_u8(a01), _to_gray_u8(b01)
    sift = cv2.SIFT_create()
    ka, da = sift.detectAndCompute(ga, None)
    kb, db = sift.detectAndCompute(gb, None)
    if da is None or db is None or len(ka) < 2 or len(kb) < 2:
        return {"num_matches": 0.0, "confidence": 0.0, "inliers": 0.0}
    bf = cv2.BFMatcher()
    raw = bf.knnMatch(da, db, k=2)
    good = [m for pair in raw if len(pair) == 2
            for m, n in [pair] if m.distance < ratio * n.distance]
    conf = float(sum(1.0 / (1.0 + m.distance) for m in good))
    inliers = 0.0
    if len(good) >= 8:
        pa = np.float32([ka[m.queryIdx].pt for m in good])
        pb = np.float32([kb[m.trainIdx].pt for m in good])
        try:
            _, mask = cv2.findFundamentalMat(pa, pb, cv2.USAC_MAGSAC,
                                             1.0, 0.999, 10000)
            inliers = float(mask.sum()) if mask is not None else 0.0
        except Exception:
            inliers = 0.0
    return {"num_matches": float(len(good)), "confidence": conf,
            "inliers": inliers}


def scene_consistency(images01: Dict[str, np.ndarray],
                      pairs: Sequence[Tuple[str, str]] = ARGOVERSE_PAIRS,
                      matcher: Optional[Callable] = None
                      ) -> Dict[str, float]:
    """Sum the overlap agreement over all adjacent camera pairs of one
    scene. images01: cam_name -> (h, w, 3) in [0,1]; `matcher` as in
    match_strips."""
    total = {"num_matches": 0.0, "confidence": 0.0, "inliers": 0.0}
    for left, right in pairs:
        if left not in images01 or right not in images01:
            continue
        a, b = edge_windows(images01[left], images01[right])
        m = match_strips(a, b, matcher=matcher)
        for k in total:
            total[k] += m[k]
    return total


def consistency_ratio(gen: Dict[str, np.ndarray],
                      gt: Dict[str, np.ndarray],
                      pairs: Sequence[Tuple[str, str]] = ARGOVERSE_PAIRS,
                      matcher: Optional[Callable] = None
                      ) -> Dict[str, float]:
    """Generated-vs-GT consistency: the reference reports summed match
    confidence for both and their ratio."""
    g = scene_consistency(gen, pairs, matcher)
    t = scene_consistency(gt, pairs, matcher)
    return {
        "gen_confidence": g["confidence"],
        "gt_confidence": t["confidence"],
        "ratio": g["confidence"] / t["confidence"] if t["confidence"] else 0.0,
        "gen_inliers": g["inliers"],
        "gt_inliers": t["inliers"],
    }
