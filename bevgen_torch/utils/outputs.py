"""Generated-image sinks: the output tree the metrics pipeline consumes.

The port's copy of `bevgen_tpu/utils/outputs.py`: the same files for the
same numpy batch.
Equivalent of the reference `GenerateImages` callback
(utils/callback.py:33-164): per sample writes

  <save_dir>/sample/<token>/<cam>.jpg      generated images
  <save_dir>/sample_gt/<token>/<cam>.jpg   ground truth
  <save_dir>/sample/<token>/bev.npz(+png)  conditioning raster
  <save_dir>/viz/<token>.png               composite figure

so the reference's metrics scripts (scripts/metrics_eval.py) run
unchanged on our outputs. `rand_str` appends a random suffix to tokens
to allow multiple samples per scene (callback.py:64).
"""
from __future__ import annotations

import random
import string
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from bevgen_torch.data.camera_geometry import denormalize_image
from bevgen_torch.utils.image import Im
from bevgen_torch.utils.viz import scene_figure, viz_bev


def sample_camera_names(cam_names, b: int, n_cams: int):
    """The camera names of sample `b`: `cam_names` is one list of names for
    the whole batch (the fake batch) or one list per sample (what
    `datamodule.collate` makes of the dataset's per-sample lists). The JAX
    package's writer reads `cam_names[c][b]`, the layout of torch's
    default_collate, which its own collate does not make."""
    if cam_names and isinstance(cam_names[0], (list, tuple)):
        return [str(n) for n in cam_names[b][:n_cams]]
    return [str(n) for n in cam_names[:n_cams]]


class GenerationWriter:
    def __init__(self, save_dir: str, rand_str: bool = False,
                 save_viz: bool = True, denormalize: bool = True,
                 layout: str = "argoverse",
                 background: bool = False, max_pending: int = 4):
        """layout='argoverse' writes sample/ sample_gt/; 'nuscenes'
        writes the flat gen/ gt/ rec/ trees (callback.py's nuScenes
        mode, consumed by metrics_eval's nuScenes path).

        background=True moves JPEG encode/IO to a writer thread so the
        serving loop can dispatch the next device batch immediately
        (the reference writes synchronously between batches); call
        `flush()` before reading the tree or exiting. Backpressure:
        at most `max_pending` batches queue before write_batch blocks
        on the oldest — bounds host memory when generation outpaces
        IO."""
        self.save_dir = Path(save_dir)
        self.rand_str = rand_str
        self.save_viz = save_viz
        self.denormalize = denormalize
        self.layout = layout
        self._executor = None
        self._pending = []
        self._max_pending = max_pending
        if background:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="genwriter")

    def flush(self):
        """Block until every queued write has settled; re-raise the
        first writer-thread error. All futures are awaited even when
        one raises (the 'call flush() before reading the tree' contract
        must hold on the error path too), and the queue is always
        cleared so a failed flush doesn't re-raise stale errors on
        every later write."""
        pending, self._pending = self._pending, []
        first_err = None
        for f in pending:
            try:
                f.result()
            except Exception as e:  # settle the rest before raising
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def _token(self, token: str) -> str:
        if self.rand_str:
            suffix = "".join(random.choices(
                string.ascii_uppercase + string.digits, k=5))
            return f"{token}_{suffix}"
        return token

    def write_batch(self, gen_images: np.ndarray,
                    batch: Dict, gt_images: Optional[np.ndarray] = None,
                    rec_images: Optional[np.ndarray] = None):
        """gen_images: (b, cam, H, W, 3) normalized or [0,1] floats.
        batch: the dataset batch dict (segmentation, cam_name,
        sample_token). rec_images: optional stage-1 reconstructions of
        the GT (the reference log_images' 'rec' output,
        cond_transformer_multi_view_muse.py:283).
        Returns the written sample dirs (background mode: queues the
        work and returns [] — flush() to complete)."""
        if self._executor is not None:
            # backpressure: bound queued batches (each pins full image
            # copies) by waiting on the oldest
            while len(self._pending) >= self._max_pending:
                self._pending.pop(0).result()
            # materialize device arrays on THIS thread (host transfer),
            # hand the pure-IO tail to the pool
            args = (np.asarray(gen_images), dict(batch),
                    None if gt_images is None else np.asarray(gt_images),
                    None if rec_images is None else np.asarray(rec_images))
            self._pending.append(
                self._executor.submit(self._write_batch_sync, *args))
            return []
        return self._write_batch_sync(gen_images, batch, gt_images,
                                      rec_images)

    def _write_batch_sync(self, gen_images, batch, gt_images=None,
                          rec_images=None):
        gen = np.asarray(gen_images, np.float32)
        if self.denormalize:
            gen = denormalize_image(gen)
        gt = rec = None
        if gt_images is not None:
            gt = np.asarray(gt_images, np.float32)
            if self.denormalize:
                gt = denormalize_image(gt)
        if rec_images is not None:
            rec = np.asarray(rec_images, np.float32)
            if self.denormalize:
                rec = denormalize_image(rec)

        if self.layout == "nuscenes":
            return self._write_nuscenes(gen, gt, rec, batch)

        cam_names = batch["cam_name"]
        written = []
        for b, token in enumerate(batch["sample_token"]):
            tok = self._token(token)
            names = sample_camera_names(cam_names, b, gen.shape[1])
            sdir = self.save_dir / "sample" / tok
            gdir = self.save_dir / "sample_gt" / tok
            for c, name in enumerate(names):
                Im(gen[b, c]).save(sdir / f"{name}.jpg")
                if gt is not None:
                    Im(gt[b, c]).save(gdir / f"{name}.jpg")
            seg = np.asarray(batch["segmentation"][b], np.float32)
            sdir.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(sdir / "bev.npz", seg)
            viz_bev(seg).save(sdir / "bev.png")
            if gt is not None:
                gdir.mkdir(parents=True, exist_ok=True)
                np.savez_compressed(gdir / "bev.npz", seg)
            if rec is not None:
                rdir = self.save_dir / "sample_rec" / tok
                for c, name in enumerate(names):
                    Im(rec[b, c]).save(rdir / f"{name}.jpg")
            if self.save_viz:
                fig = scene_figure(gen[b], seg, names,
                                   gt[b] if gt is not None else None)
                fig.save(self.save_dir / "viz" / f"{tok}.png")
            written.append(sdir)
        return written

    def _write_nuscenes(self, gen, gt, rec, batch):
        """Flat gen/ gt/ rec/ trees keyed <token>_<cam>.jpg
        (callback.py's nuScenes output mode)."""
        cam_names = batch["cam_name"]
        written = []
        for b, token in enumerate(batch["sample_token"]):
            tok = self._token(token)
            names = sample_camera_names(cam_names, b, gen.shape[1])
            for c, name in enumerate(names):
                Im(gen[b, c]).save(self.save_dir / "gen" /
                                   f"{tok}_{name}.jpg")
                if gt is not None:
                    Im(gt[b, c]).save(self.save_dir / "gt" /
                                      f"{tok}_{name}.jpg")
                if rec is not None:
                    Im(rec[b, c]).save(self.save_dir / "rec" /
                                       f"{tok}_{name}.jpg")
            written.append(tok)
        return written
