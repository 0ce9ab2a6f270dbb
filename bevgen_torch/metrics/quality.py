"""Paired image-quality metrics: PSNR, SSIM, LPIPS.

Port of `bevgen_tpu/metrics/quality.py` (the reference evaluates with
torchmetrics' LPIPS, SSIM and PSNR over generated-vs-ground-truth pairs).
PSNR and SSIM are numpy; LPIPS runs `models/lpips.py` when its converted
weights are there.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio over [0, data_range] images."""
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean structural similarity per channel with a gaussian window (size
    11, sigma 1.5) over the valid interior: torchmetrics'
    StructuralSimilarityIndexMeasure defaults."""
    from scipy.ndimage import gaussian_filter
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    r = win_size // 2

    def filt(x):  # the kernel's support is exactly win_size taps
        return gaussian_filter(x, sigma, truncate=r / sigma)

    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mu_x, mu_y = filt(x), filt(y)
        xx = filt(x * x) - mu_x ** 2
        yy = filt(y * y) - mu_y ** 2
        xy = filt(x * y) - mu_x * mu_y
        num = (2 * mu_x * mu_y + c1) * (2 * xy + c2)
        den = (mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2)
        vals.append((num / den)[r:-r, r:-r].mean())
    return float(np.mean(vals))


class LPIPSMetric:
    """Batched LPIPS on `device` (cuda unless the caller asks for the CPU);
    `available` is False when there are no converted weights, and then no
    model is built. The model's parameters are frozen."""

    def __init__(self, weights_npz: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        from bevgen_torch.core.convert import load_jax_params
        from bevgen_torch.core.device import resolve_device
        from bevgen_torch.models.lpips import LPIPS, load_lpips_params
        params = load_lpips_params(weights_npz) if weights_npz else None
        self.model = None
        if params is not None:
            self.model = load_jax_params(LPIPS(), params).to(
                resolve_device(device)).eval().requires_grad_(False)

    @property
    def available(self) -> bool:
        return self.model is not None

    @torch.no_grad()
    def __call__(self, a01: np.ndarray, b01: np.ndarray) -> np.ndarray:
        """a01, b01: (b, h, w, 3) in [0, 1]. Returns the (b,) distances."""
        if not self.available:
            raise RuntimeError("LPIPS weights are not available")
        dev = next(self.model.parameters()).device
        x = torch.as_tensor(np.asarray(a01, np.float32), device=dev) * 2 - 1
        y = torch.as_tensor(np.asarray(b01, np.float32), device=dev) * 2 - 1
        return self.model(x, y).cpu().numpy()
