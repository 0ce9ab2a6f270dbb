"""Experiment logging: JSONL + console + optional wandb.

The port's copy of `bevgen_tpu/utils/logging.py`. The reference logs through
wandb/Lightning (SURVEY §5.5). Here a dependency-light `MetricsLogger`
writes structured JSONL (always) and mirrors to wandb when the package is
importable; image artifacts (attention layouts, bias matrices, sample
grids) save to the run dir — the reference logs the same artifacts at
train/test start (cond_transformer_multi_view.py:386-400). Metric values may
be python numbers, numpy arrays or torch tensors (on any device).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


def _jsonable(v):
    """Scalars (python, 0-d arrays or tensors) -> float; multi-element
    arrays or tensors -> list; anything else as it is."""
    if isinstance(v, (int, float)):
        return float(v)
    if hasattr(v, "item"):
        if hasattr(v, "detach"):  # a torch tensor
            v = v.detach().cpu().numpy()
        return float(v) if np.ndim(v) == 0 else np.asarray(v).tolist()
    return v


class MetricsLogger:
    def __init__(self, run_dir: str, project: str = "bevgen_torch",
                 use_wandb: bool = True, config: Optional[Dict] = None):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, dir=str(self.dir),
                                         config=config or {})
            except Exception:
                self._wandb = None
        if config:
            (self.dir / "config.json").write_text(
                json.dumps(config, indent=2, default=str))

    def log(self, step: int, metrics: Dict[str, Any]):
        rec = {"step": step, "time": time.time(),
               **{k: _jsonable(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({k: _jsonable(v) for k, v in metrics.items()},
                            step=step)

    def log_image(self, name: str, image: np.ndarray, step: int = 0):
        from bevgen_torch.utils.image import Im
        path = self.dir / "images" / f"{name}_{step:06d}.png"
        Im(image).save(path)
        if self._wandb is not None:
            import wandb
            self._wandb.log({name: wandb.Image(str(path))}, step=step)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def save_mask_plots(cfg, out_dir: str):
    """Render the attention artifacts as images (the reference's
    layout/bias logging at train start + mask_generator plot hooks)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from bevgen_torch.models import masks

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def save(name, arr):
        plt.imsave(out / f"{name}.png", np.asarray(arr, np.float32),
                   cmap="hot", vmin=0, vmax=1)

    if cfg.camera_bias:
        save("camera_bias_prob_matrix", masks.camera_bias_matrix(cfg))
        save("bev_to_cam_bias", masks.bev_cam_sim_matrix(cfg))
    sm = masks.sparse_masks(cfg)
    save("allowed_pattern", sm.allowed)
    save("static_layout", sm.static_layout.astype(np.float32))
    save("prob_layout", sm.prob_layout /
         max(float(sm.prob_layout.max()), 1e-9))
    for h in range(min(4, sm.layouts.shape[0])):
        save(f"layout_head{h}", sm.layouts[h].astype(np.float32))
    return out
