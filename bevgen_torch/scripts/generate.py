"""Batch generation CLI for the PyTorch port: the reference's `generate.py`.

    python -m bevgen_torch.scripts.generate preset=argoverse_muse \\
        batch_size=4 eval_generate=/data/out ckpt_path=pretrained.ckpt \\
        datamodule.split=val
    python -m bevgen_torch.scripts.generate preset=argoverse_muse_7cam \\
        batch_size=2 fake=2 seed=0 device=cuda out=output/torch_generate
    python -m bevgen_torch.scripts.generate pipeline=ar preset=nuscenes_ar \\
        transformer.num_layers=2 device=cpu fake=1
    python -m bevgen_torch.scripts.generate fake=1 batch_size=2 \\
        keep_cameras=ring_front_left,ring_front_center save_rec=true
    python -m bevgen_torch.scripts.generate preset=argoverse_muse_7cam \\
        batch_size=2 fake=2 quant=auto
    python -m bevgen_torch.scripts.generate config=bevgen_torch/configs/\\
argoverse_muse.yaml modes=[argoverse,generate] eval_generate=/data/out
    torchrun --nproc_per_node=2 -m bevgen_torch.scripts.generate \\
        preset=argoverse_muse_7cam batch_size=4 fake=2 dp=2
    torchrun --nproc_per_node=4 -m bevgen_torch.scripts.generate \\
        preset=argoverse_muse_7cam batch_size=4 fake=2 dp=2 tp=2

Data: `fake=N` runs N batches of the fake-batch fixture; without it the
CLI reads the Argoverse tree under ARGOVERSE_DATA_DIR
(`data/argoverse.py:ArgoverseDataset`, the reference's three front
cameras; the preset must have as many, else it exits naming both counts)
through the port's loader: `datamodule.split` (default val; test under
`modes=[...,generate]`), `mini_dataset=N` (the first N samples),
`bev_dir_name`, `limit_batches`. The pipeline: `pipeline=muse` (default;
preset argoverse_muse_7cam) runs `BEVGenPipeline.generate_fn`,
`pipeline=ar` (preset nuscenes_ar) `ARPipeline.generate_fn` (top_k 100,
temperature 1), KV-cached unless `cached=false`. The weights are seeded
random (`seed`) unless `ckpt_path` names a checkpoint
(`training/checkpoints.py:load_weights`: one of the reference's torch
checkpoints or one of the port's own tags; `ema=true` loads the tag's `-EMA`
sibling and needs `ckpt_path`). `quant=int8` serves the int8 pipeline
(`quantized()`: W8A8 for MUSE, int8 weights for AR, made from the loaded
weights); `quant=auto` passes `batch_size` as the hint, so MUSE keeps bf16
where the card's crossover table (`bevgen_torch/configs/
int8_crossover.json`) measured bf16 faster at that batch; `quant=none`
(default) serves as loaded.

`keep_cameras=<names>` (from the config's camera names) encodes the batch's
`image` and keeps those cameras' tokens fixed: every other camera starts at
the mask id and is generated (MUSE and AR). `save_rec=true` adds an
encode -> decode reconstruction of the batch's images.

Outputs: with `eval_generate=<dir>`, the reference's tree through
`utils/outputs.py:GenerationWriter` (`layout=argoverse`: sample/,
sample_gt/, sample_rec/; `layout=nuscenes`; `rand_str=true`), and on real
data the samples already in that tree are skipped. `out=<dir>` (by default
output/torch_generate when `eval_generate` is not given) gets one
`batch_XXXX.npz` per batch with the decode `ids` (b, cam, h, w), the
`images` (b, cam, H, W, 3) and, under `save_rec`, `rec`. The last line is one
JSON object {"images", "seconds", "images_per_sec"}. The pipeline runs on
the card (`device`, default cuda; it raises without one; `platform=cpu|gpu`
and `devices=1` as the reference takes them, `scripts/cli.py:pop_device`).
The composed config is printed first as plain text unless
`print_config=false`. Under torchrun, `dp` and `dcn` (`scripts/cli.py:
pop_mesh`) split each batch over the data rows and `tp` the transformer's
heads and FFN hidden over the ranks of a row
(`pipelines.generate.make_sharded_generate` or
`ar_generate.make_sharded_ar_generate`: every rank reads the batch and
decodes its row's rows, the draws made at the whole batch's shape), and
rank 0 gathers the ids and images and writes the same tree a one-process
run writes; `quant=` quantizes each rank's whole copy (`auto` with the
global batch as the hint, as the JAX CLI decides), which `tp` then cuts,
and `transformer.use_fused_glue=true` serves its glue under tp as well. A
`tp` that does not divide the heads and `keep_cameras` with a mesh exit,
the last as in the JAX CLI.
`config=`, `preset=`, `modes=` and dotted overrides
(`transformer.num_layers=2`) build the config (`scripts/cli.py`); any other
argument exits.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from bevgen_torch.scripts import cli


def _mini_dataset(value: Optional[str]) -> Optional[int]:
    """`mini_dataset=N`: the first N samples (0 or absent: all)."""
    if value is None:
        return None
    try:
        n = int(value)
    except ValueError:
        raise SystemExit(f"mini_dataset takes a sample count (mini_dataset=8), "
                         f"got {value!r}")
    return n or None


def _kept_cameras(value: str, camera_names) -> List[int]:
    """Indices, in the config's camera order, of the `keep_cameras` names."""
    names = [c for c in value.split(",") if c]
    unknown = sorted(set(names) - set(camera_names))
    if unknown:
        raise SystemExit(f"keep_cameras: {unknown} not among the config's "
                         f"cameras {list(camera_names)}")
    return [c for c, name in enumerate(camera_names) if name in names]


def init_ids_keeping(gt_tokens, kept: List[int], mask_id: int):
    """(b, cam, hw) ids: the kept cameras' encoded tokens, the mask id
    elsewhere."""
    import torch
    init_ids = torch.full_like(gt_tokens, mask_id)
    init_ids[:, kept] = gt_tokens[:, kept]
    return init_ids


def run(argv: List[str]):
    """The CLI's work: returns the pipeline it served with and the paths of
    the npz batches it wrote (none without `out`)."""
    import torch
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.ar_generate import (ARPipeline,
                                                    make_sharded_ar_generate)
    from bevgen_torch.pipelines.generate import (BEVGenPipeline,
                                                 make_sharded_generate)
    from bevgen_torch.training.checkpoints import load_weights, resolve_ema_path

    args = cli.parse_argv(argv)
    ar = cli.pop_pipeline_kind(args)
    cfg, args = cli.build_config(args, cli.default_preset(ar))
    batch_size = cfg.batch_size or 1
    seed = cfg.seed
    fake = int(args.pop("fake", 0))
    device = cli.pop_device(args)
    mesh_args = {k: args.pop(k) for k in ("dp", "tp", "dcn") if k in args}
    save_dir = args.pop("eval_generate", None)
    out_dir = args.pop("out", None if save_dir else
                       os.path.join("output", "torch_generate"))
    ckpt_path = args.pop("ckpt_path", None)
    use_ema = cli.pop_flag(args, "ema")
    split = args.pop("datamodule.split", "val")
    limit = int(args.pop("limit_batches", 0))
    layout = args.pop("layout", "argoverse")
    rand_str = cli.pop_flag(args, "rand_str")
    mini_dataset = _mini_dataset(args.pop("mini_dataset", None))
    bev_dir_name = args.pop("bev_dir_name", "bev_seg_full_11_14")
    save_rec = cli.pop_flag(args, "save_rec")
    tf = cfg.transformer
    kept = _kept_cameras(args.pop("keep_cameras", ""), tf.camera_names)
    sample_kw = {"cached": cli.pop_flag(args, "cached", "true")} if ar else {}
    quant = cli.pop_quant(args)
    show_config = cli.pop_flag(args, "print_config", "true")
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    mesh = cli.pop_mesh(mesh_args, device, tf)
    ways = 1 if mesh is None else mesh.size
    main_rank = mesh is None or mesh.rank == 0
    if mesh is not None and kept:
        raise SystemExit("keep_cameras (partial decode) is not supported "
                         "together with a device mesh")
    if batch_size % ways:
        raise SystemExit(f"batch_size={batch_size} must be divisible by the "
                         f"data-parallel ways dcn*dp ({ways})")
    if show_config and main_rank:
        print(cli.config_text(cfg, extra={
            "eval_generate": save_dir, "ckpt_path": ckpt_path,
            "pipeline": "ar" if ar else "muse", "quant": quant,
            "split": split, "fake": fake}), flush=True)
    if use_ema and not ckpt_path:
        raise SystemExit("ema=true requires ckpt_path=")
    if fake < 0:
        raise SystemExit(f"fake={fake}: pass a count of fake batches")
    dev = resolve_device(device)

    if fake:
        batches = (fake_batch(cfg, batch_size, seed=seed + i)
                   for i in range(fake))
    else:
        from bevgen_torch.data import datamodule as dm
        from bevgen_torch.data.argoverse import ArgoverseDataset
        ds = ArgoverseDataset(split=split, eval_generate=save_dir,
                              cam_res=tf.cam_res, mini_dataset=mini_dataset,
                              bev_dir_name=bev_dir_name)
        cli.check_cameras(ds.cameras, tf)
        batches = iter(dm.DataLoader(ds, batch_size, shuffle=False,
                                     drop_last=True))

    pipe = (ARPipeline if ar else BEVGenPipeline).create(
        cfg, device=dev).init_params(seed)
    if ckpt_path:
        if use_ema:
            ckpt_path = resolve_ema_path(ckpt_path)
        family = load_weights(ckpt_path, pipe)
        print(f"[generate] loaded {family} weights from {ckpt_path}",
              flush=True)
    pipe = cli.apply_quant(pipe, quant, batch_size)
    if quant != "none" and main_rank:
        print(f"[generate] quant={quant}: serving "
              f"{pipe.config.transformer.quant}", flush=True)
    generate_fn = pipe.generate_fn
    if mesh is not None:
        make = make_sharded_ar_generate if ar else make_sharded_generate
        generate_fn, shard_params, shard_batch = make(pipe, mesh)
        shard_params(pipe)
    writer = None
    if save_dir and main_rank:
        from bevgen_torch.utils.outputs import GenerationWriter
        # background: JPEG encode and IO overlap the next batch
        writer = GenerationWriter(save_dir, layout=layout, background=True,
                                  rand_str=rand_str)
    if out_dir and main_rank:
        os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    h, w = tf.cam_latent_res
    paths = []
    n_done = 0
    t_start = time.perf_counter()
    for i, batch in enumerate(batches):
        if limit and i >= limit:
            break
        t0 = time.perf_counter()
        init_ids = rec = None
        arrays = [batch[k] for k in ("segmentation", "intrinsics_inv",
                                     "extrinsics_inv")]
        image = batch.get("image")
        if mesh is not None:   # this rank's rows
            arrays = shard_batch(*arrays)
            if image is not None:
                (image,) = shard_batch(image)
        if (kept or save_rec) and image is not None:
            gt_tokens = pipe.encode_images(image)            # (b, cam, hw)
            if kept:
                init_ids = init_ids_keeping(gt_tokens, kept, tf.mask_token_id)
            if save_rec:
                b, cam = gt_tokens.shape[:2]
                rec = pipe.decode_tokens(gt_tokens.reshape(b, cam, h, w))
                if mesh is not None:
                    rec = mesh.gather_rows(rec)
                rec = rec.float().cpu().numpy()
        images, ids = generate_fn(*arrays, gen, init_ids=init_ids,
                                  **sample_kw)
        if mesh is not None:   # the whole batch, on every rank
            images, ids = mesh.gather_rows(images), mesh.gather_rows(ids)
        images = images.float().cpu().numpy()
        dt = time.perf_counter() - t0
        n_done += images.shape[0] * images.shape[1]
        if not main_rank:
            continue
        if out_dir:
            path = os.path.join(out_dir, f"batch_{i:04d}.npz")
            extra = {} if rec is None else {"rec": rec}
            np.savez(path, ids=ids.cpu().numpy(), images=images, **extra)
            paths.append(path)
        if writer is not None:
            writer.write_batch(images, batch, gt_images=batch.get("image"),
                               rec_images=rec)
        print(f"[generate] batch {i}: {images.shape[0] * images.shape[1]} "
              f"images in {dt:.3f} s" + (f" -> {path}" if out_dir else ""),
              flush=True)
    if writer is not None:
        writer.flush()
    dt = time.perf_counter() - t_start
    if mesh is not None:
        mesh.close()
    if main_rank:
        print(json.dumps({"images": n_done, "seconds": round(dt, 2),
                          "images_per_sec": round(n_done / dt, 3) if dt
                          else 0}))
    return pipe, paths


def main(argv: Optional[List[str]] = None) -> int:
    run(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
