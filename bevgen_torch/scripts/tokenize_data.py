"""Tokenize a dataset once with the stage-1 encoders into token shards for
stage-2 training (`data/tokens.py:tokenize_dataset`; read back by
`scripts/train_stage2.py tokens_dir=`).

    python -m bevgen_torch.scripts.tokenize_data preset=argoverse_muse \\
        out_dir=/data/tokens ckpt_path=stage1.ckpt datamodule.split=train
    python -m bevgen_torch.scripts.tokenize_data preset=tiny_test \\
        out_dir=/tmp/tokens fake=4 batch_size=2 device=cpu

Data: `fake=N` tokenizes N batches of the fake-batch fixture
(`fake_batch(cfg, batch_size, seed=seed + i)`); without it the Argoverse
tree under ARGOVERSE_DATA_DIR (`datamodule.split`, default train; the
reference's three front cameras, so the preset must have as many, else it
exits naming both counts) through the port's loader. Batches reach the
pipeline's device through `datamodule.device_prefetch`. Options: `out_dir` (required), `ckpt_path`
(weights loaded over the seeded init by `load_weights`), `shard_size`
(samples per shard, default 1024), `batch_size` (default 8), `seed`,
`device` (default cuda; raises without one; or `platform=cpu|gpu`,
`devices=1`, `scripts/cli.py:pop_device`), `config=`/`preset=` and
dotted overrides (`scripts/cli.py`); any other argument exits.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from bevgen_torch.scripts import cli


def main(argv: Optional[List[str]] = None) -> int:
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.data import datamodule as dm
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.data.tokens import tokenize_dataset
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.training.checkpoints import load_weights

    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    cfg, args = cli.build_config(args, "argoverse_muse")
    if "out_dir" not in args:
        raise SystemExit("tokenize_data needs out_dir=<shard directory>")
    out_dir = args.pop("out_dir")
    ckpt_path = args.pop("ckpt_path", None)
    split = args.pop("datamodule.split", "train")
    shard_size = int(args.pop("shard_size", 1024))
    fake = int(args.pop("fake", 0))
    device = cli.pop_device(args)
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    batch_size = cfg.batch_size or 8
    dev = resolve_device(device)

    if fake:
        batches = (fake_batch(cfg, batch_size, seed=cfg.seed + i)
                   for i in range(fake))
    else:
        from bevgen_torch.data.argoverse import ArgoverseDataset
        ds = ArgoverseDataset(split=split, cam_res=cfg.transformer.cam_res)
        cli.check_cameras(ds.cameras, cfg.transformer)
        batches = dm.DataLoader(ds, batch_size, shuffle=False, drop_last=True)
    pipe = BEVGenPipeline.create(cfg, device=dev).init_params(cfg.seed)
    if ckpt_path:
        family = load_weights(ckpt_path, pipe)
        print(f"[tokenize_data] loaded {family} weights from {ckpt_path}",
              flush=True)
    n = tokenize_dataset(pipe, dm.device_prefetch(batches, dev), out_dir,
                         shard_size=shard_size)
    print(f"[tokenize_data] tokenized {n} samples -> {out_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
