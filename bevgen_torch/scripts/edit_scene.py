"""Scene-editing CLI: edit annotations -> re-rasterize BEV -> regenerate.

The port's counterpart of `bevgen_tpu/scripts/edit_scene.py`, the headless
form of the reference's gradio editing demo
(scripts/interactive_editing.py:246-343): applies edits (add or remove
cuboids) to a scene, rasterizes it with the preprocessing's
`data/rasterize.py:rasterize_scene` and regenerates the camera images with
`BEVGenPipeline.generate_fn` at batch 1.

    python -m bevgen_torch.scripts.edit_scene preset=argoverse_muse_7cam \\
        edits='[{"op":"add","category":"REGULAR_VEHICLE","x":10,"y":0,
                 "yaw":0,"length":4.5,"width":2.0}]' \\
        out_dir=output/edited [ckpt_path=...] [seed=0]
    BEVGEN_NATIVE_RASTER=1 python -m bevgen_torch.scripts.edit_scene ...

The scene starts from an empty drivable square (70 m a side). The
weights are seeded random (`seed`) unless `ckpt_path` names a checkpoint
(`training/checkpoints.py:load_weights`); the gumbel and critic noise come
from a `torch.Generator` seeded with seed + 1 (JAX: `PRNGKey(seed + 1)`).
`out_dir` (default output/edited) gets the reference's tree through
`utils/outputs.py:GenerationWriter`, sample token `edited`. The pipeline
runs on the card (`device`, default cuda; it raises without one;
`platform=cpu|gpu` as the reference takes it) in the config's dtype (bf16
unless `dtype=float32`). `preset=` (default argoverse_muse), `config=`,
`modes=` and dotted overrides build the config; any other argument exits.
The rasters are drawn by cv2, or by the native C++ core under
`BEVGEN_NATIVE_RASTER=1` (the card's machine has no cv2).

Two departures from the JAX script: `seed=` takes effect (there the config
takes the key first, so the script always draws with seed 0), and an
unknown argument exits.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from bevgen_torch.scripts import cli

# the base scene's drivable area, in ego metres
DRIVABLE_SQUARE = np.array(
    [[-35, -35, 0], [-35, 35, 0], [35, 35, 0], [35, -35, 0]], np.float64)


def cuboid_quad(x: float, y: float, yaw: float, length: float,
                width: float) -> np.ndarray:
    """(4, 3) ego-frame footprint of a cuboid at (x, y) turned by yaw."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    l, w = length / 2.0, width / 2.0
    corners = np.array([[l, w, 0], [l, -w, 0], [-l, -w, 0], [-l, w, 0]])
    return (R @ corners.T).T + np.array([x, y, 0.0])


def apply_edits(cuboids, edits):
    """cuboids: list of (category, (4,3) ego footprint). Edits:
    {"op": add/remove, ...}; remove drops by index."""
    out = list(cuboids)
    for e in edits:
        if e["op"] == "add":
            quad = cuboid_quad(e["x"], e["y"], float(e.get("yaw", 0.0)),
                               e["length"], e["width"])
            out.append((e.get("category", "REGULAR_VEHICLE"), quad))
        elif e["op"] == "remove":
            idx = int(e["index"])
            if 0 <= idx < len(out):
                out.pop(idx)
    return out


def rasterize_cuboids(cuboids, resolution: int) -> np.ndarray:
    """The editor's scene: the drivable square and `cuboids`, no lanes."""
    from bevgen_torch.data import rasterize
    return rasterize.rasterize_scene(
        drivable_polygons_ego=[DRIVABLE_SQUARE],
        cuboid_footprints_ego=cuboids, lane_boundaries_ego=[],
        stoplines_ego=[], ped_crossing_polygons_ego=[],
        resolution=resolution)


def run(argv: List[str]) -> Tuple[np.ndarray, Dict, np.ndarray]:
    """The CLI's work without the writing: returns the generated images
    (1, cam, H, W, 3) fp32 (normalized, as `generate_fn` gives them), the
    batch the writer takes and the raster (res, res, 7)."""
    import torch
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.training.checkpoints import load_weights

    args = cli.parse_argv(argv)
    cfg, args = cli.build_config(args, "argoverse_muse")
    device = cli.pop_device(args)
    edits = json.loads(args.pop("edits", "[]"))
    args.pop("out_dir", None)
    ckpt_path = args.pop("ckpt_path", None)
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    dev = resolve_device(device)
    seed = cfg.seed

    cuboids = apply_edits([], edits)
    layers = rasterize_cuboids(cuboids, cfg.cond_stage.resolution)
    print(f"rasterized {len(cuboids)} cuboids -> {layers.shape}", flush=True)

    pipe = BEVGenPipeline.create(cfg, device=dev).init_params(seed)
    if ckpt_path:
        family = load_weights(ckpt_path, pipe)
        print(f"[edit_scene] loaded {family} weights from {ckpt_path}",
              flush=True)
    batch = fake_batch(cfg, batch_size=1, seed=seed)
    batch["segmentation"] = layers[None]
    batch["sample_token"] = ["edited"]
    gen = torch.Generator(device=pipe.device).manual_seed(seed + 1)
    images, _ = pipe.generate_fn(batch["segmentation"],
                                 batch["intrinsics_inv"],
                                 batch["extrinsics_inv"], gen)
    return images.float().cpu().numpy(), batch, layers


def main(argv: Optional[List[str]] = None) -> int:
    from bevgen_torch.utils.outputs import GenerationWriter
    argv = sys.argv[1:] if argv is None else argv
    out_dir = cli.parse_argv(argv).get("out_dir", "output/edited")
    images, batch, _ = run(argv)
    GenerationWriter(out_dir).write_batch(images, batch)
    print(f"wrote edited scene to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
