"""Pseudo-segmentation data prep (reference scripts/cityscapes_gen.py): the
port's counterpart of `bevgen_tpu/scripts/pseudo_seg.py`.

The reference runs a cityscapes-trained PaddleSeg OCRNet over every
nuScenes camera image and writes the predicted class-id map as a
`.npz` mirror of the image tree (baseline-comparison data prep,
cityscapes_gen.py:106-123). PaddleSeg + its pretrained weights are the
author's local artifacts, so this re-design makes the segmentation
model pluggable and keeps the IO contract:

  * input: any directory tree of `.jpg` images (nuScenes `samples/`,
    AV2 `sensors/cameras/`, or generated `sample/` trees);
  * model: `--model-path` pointing at either a TorchScript module or a
    HuggingFace `transformers` semantic-segmentation checkpoint
    directory on local disk (zero-egress image: weights must already
    be present — same gating policy as LPIPS/FID weights);
  * output: the image tree mirrored under save_dir with each image's
    extension replaced by `.npz` (`x/y/123.jpg` -> `x/y/123.npz`,
    `pred` uint8 (H, W) class ids — same `with_suffix` contract as
    cityscapes_gen.py:118), images resized to size= (default 384x192,
    cityscapes_gen.py:53).

Usage:
  python -m bevgen_torch.scripts.pseudo_seg image_root=/data/nuscenes \
      save_dir=/data/nuscenes_cityscapes model_path=/weights/ocrnet.pt \
      shard=0 num_shards=4 [device=cpu]

The model runs on `device` (default cuda; it raises without one, before it
loads anything; `platform=cpu|gpu` as the other CLIs take it): the
TorchScript module is loaded onto it, and the images go to it a batch at a
time. The images are read with PIL, which the card's machine does not
have, so the script is held on the CPU only. An unknown argument exits (the
JAX script prints it and goes on).
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from bevgen_torch.scripts import cli


def _load_model(model_path: str, device="cuda"):
    """TorchScript file or transformers checkpoint dir -> callable
    (B, 3, H, W) float [0,1] -> (B, H, W) int64 class ids, run on `device`
    (the input is moved there)."""
    import torch
    from bevgen_torch.core.device import resolve_device

    device = resolve_device(device)
    p = Path(model_path)
    if p.is_file():
        model = torch.jit.load(str(p), map_location=device).eval()

        def run(img):
            with torch.no_grad():
                out = model(img.to(device))
            if isinstance(out, (list, tuple)):
                out = out[0]
            return out.argmax(1) if out.ndim == 4 else out
        return run

    from transformers import (AutoImageProcessor,
                              AutoModelForSemanticSegmentation)
    proc = AutoImageProcessor.from_pretrained(str(p), local_files_only=True)
    model = AutoModelForSemanticSegmentation.from_pretrained(
        str(p), local_files_only=True).to(device).eval()

    def run(img):
        with torch.no_grad():
            inputs = proc(images=[im for im in (img * 255).to(torch.uint8)],
                          return_tensors="pt").to(device)
            logits = model(**inputs).logits
            logits = torch.nn.functional.interpolate(
                logits, size=img.shape[-2:], mode="bilinear",
                align_corners=False)
        return logits.argmax(1)
    return run


def main(argv: Optional[List[str]] = None) -> int:
    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    image_root = Path(args.pop("image_root"))
    save_dir = Path(args.pop("save_dir"))
    model_path = args.pop("model_path", None)
    w, h = (int(x) for x in args.pop("size", "384,192").split(","))
    batch_size = int(args.pop("batch_size", 32))
    shard = int(args.pop("shard", 0))
    num_shards = int(args.pop("num_shards", 1))
    device = cli.pop_device(args)
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    if model_path is None:
        raise SystemExit(
            "pseudo_seg needs model_path= (TorchScript file or local "
            "transformers segmentation checkpoint dir); this image has "
            "no bundled segmentation weights (zero egress)")

    import torch
    from PIL import Image

    run = _load_model(model_path, device)
    files = sorted(image_root.rglob("*.jpg"))
    files = files[shard::num_shards]  # reference's partition_list sharding
    print(f"pseudo_seg: {len(files)} images (shard {shard}/{num_shards})")

    for start in range(0, len(files), batch_size):
        chunk = files[start:start + batch_size]
        imgs = []
        for f in chunk:
            im = Image.open(f).convert("RGB").resize(
                (w, h), Image.Resampling.LANCZOS)
            imgs.append(np.asarray(im, np.float32) / 255.0)
        batch = torch.from_numpy(
            np.stack(imgs).transpose(0, 3, 1, 2)).contiguous()
        pred = run(batch).cpu().numpy().astype(np.uint8)
        for f, p in zip(chunk, pred):
            out = (save_dir / f.relative_to(image_root)).with_suffix(".npz")
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez(out, pred=p)
        print(f"  {start + len(chunk)}/{len(files)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
