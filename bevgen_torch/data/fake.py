"""Fake-batch fixture: run the whole serving pipeline with no dataset.

Produces numpy arrays in the reference batch schema, seeded from numpy,
with the canonical camera rig (`models.geometry.canonical_camera_rig`) so
the ray embedding sees physically consistent rays. Same arrays as the
reference's `bevgen_tpu/data/fake.py` for the same seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from bevgen_torch.core.config import PipelineConfig
from bevgen_torch.models import geometry


def fake_batch(pipe: PipelineConfig, batch_size: int = 1,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Batch dict:
      image          (b, cam, H, W, 3)   normalized float32
      segmentation   (b, bev, bev, n_labels) float32
      intrinsics(_inv) (b, cam, 3, 3)
      extrinsics(_inv) (b, cam, 4, 4)
    """
    cfg = pipe.transformer
    rng = np.random.default_rng(seed)
    cam = cfg.num_cams
    H, W = cfg.cam_res
    n_labels = pipe.cond_stage.n_labels or 7
    bev_size = pipe.cond_stage.resolution

    intr, extr = geometry.canonical_camera_rig(cfg)
    intr = np.broadcast_to(intr[None], (batch_size, cam, 3, 3)).astype(np.float32)
    extr = np.broadcast_to(extr[None], (batch_size, cam, 4, 4)).astype(np.float32)

    return {
        "image": rng.standard_normal(
            (batch_size, cam, H, W, 3)).astype(np.float32),
        "segmentation": (rng.uniform(size=(
            batch_size, bev_size, bev_size, n_labels)) < 0.2).astype(np.float32),
        "intrinsics": intr,
        "extrinsics": extr,
        "intrinsics_inv": np.linalg.inv(intr.astype(np.float64)).astype(np.float32),
        "extrinsics_inv": np.linalg.inv(extr.astype(np.float64)).astype(np.float32),
        "sample_token": [f"fake{i:05d}" for i in range(batch_size)],
        "cam_name": list(cfg.camera_names),
        "dataset": cfg.dataset,
    }
