"""Frechet Inception Distance machinery.

Port of `bevgen_tpu/metrics/fid.py` (the reference scores with clean-fid
over the sample/ vs sample_gt/ trees). The Frechet statistics (feature
accumulation -> mean/cov -> matrix-sqrt distance) are numpy in float64, the
same code as the JAX package's; the feature extractor is pluggable:

  * InceptionV3 pool3 (`metrics/inception.py`) from converted weights
    (`convert_inception_weights`); none ship with the repository;
  * any callable (images [0,1] NHWC -> (n, d) features).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Frechet statistics
# ---------------------------------------------------------------------------


class FeatureStats:
    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(0)
        self.outer += f.T @ f

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.sum / self.n
        cov = self.outer / self.n - np.outer(mu, mu)
        cov *= self.n / max(self.n - 1, 1)
        return mu, cov


def _sqrtm_product(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """sqrtm(c1 @ c2) via eigen-decomposition of the symmetrized
    problem (scipy-free, stable for PSD covariances)."""
    w, v = np.linalg.eigh(c1)
    w = np.clip(w, 0, None)
    s1 = (v * np.sqrt(w)) @ v.T
    m = s1 @ c2 @ s1
    w2, v2 = np.linalg.eigh((m + m.T) / 2)
    w2 = np.clip(w2, 0, None)
    return (v2 * np.sqrt(w2)) @ v2.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    diff = mu1 - mu2
    covmean = _sqrtm_product(cov1, cov2)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    sa = FeatureStats(feats_a.shape[1]); sa.update(feats_a)
    sb = FeatureStats(feats_b.shape[1]); sb.update(feats_b)
    return frechet_distance(*sa.finalize(), *sb.finalize())


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------


def pixel_statistics_features(images01: np.ndarray, grid: int = 8
                              ) -> np.ndarray:
    """Weight-free fallback features: per-cell color means over a
    grid. ONLY for relative tracking when no pretrained extractor weights
    are present — clearly not paper FID."""
    import cv2
    out = []
    for img in images01:
        small = cv2.resize(img.astype(np.float32), (grid, grid),
                           interpolation=cv2.INTER_AREA)
        out.append(small.reshape(-1))
    return np.stack(out)


def make_inception_features(weights_npz: str, batch_size: int = 32,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Optional[Callable]:
    """InceptionV3 pool3 feature extractor from converted weights on
    `device`; None when the weights file is absent. The extractor maps
    (n, h, w, 3) images in [0, 1] to (n, 2048) float32 features, fp32 under
    `torch.inference_mode()`."""
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.metrics.inception import load_inception
    dev = resolve_device(device)
    if not Path(weights_npz).exists():
        return None
    model = load_inception(weights_npz).to(dev)

    def extract(images01: np.ndarray) -> np.ndarray:
        feats = []
        with torch.inference_mode():
            for i in range(0, len(images01), batch_size):
                batch = torch.as_tensor(
                    np.asarray(images01[i:i + batch_size], np.float32),
                    device=dev)
                feats.append(model(batch).cpu().numpy())
        return np.concatenate(feats)

    return extract


# ---------------------------------------------------------------------------
# directory-tree evaluation (the metrics_eval.py surface)
# ---------------------------------------------------------------------------


def load_image_dir(root: str, max_images: Optional[int] = None,
                   size: Tuple[int, int] = (256, 256)) -> np.ndarray:
    """Load sample/<token>/<cam>.jpg trees into (n, h, w, 3) [0,1]."""
    import cv2
    root = Path(root)
    files = sorted(root.rglob("*.jpg"))
    if max_images:
        files = files[:max_images]
    imgs = []
    for f in files:
        img = cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
        if img.shape[:2] != size:
            img = cv2.resize(img, (size[1], size[0]))
        imgs.append(img.astype(np.float32) / 255.0)
    return np.stack(imgs) if imgs else np.zeros((0, *size, 3), np.float32)


def fid_between_dirs(dir_a: str, dir_b: str,
                     feature_fn: Optional[Callable] = None,
                     max_images: Optional[int] = None) -> float:
    feature_fn = feature_fn or pixel_statistics_features
    a = load_image_dir(dir_a, max_images)
    b = load_image_dir(dir_b, max_images)
    return fid_from_features(feature_fn(a), feature_fn(b))
