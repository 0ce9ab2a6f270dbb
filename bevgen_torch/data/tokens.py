"""Pre-tokenised stage-2 training data: tokenize a dataset once with the
stage-1 encoders (`tokenize_dataset`), then train stage 2 from the shards.
The port's own copy of `bevgen_tpu/data/tokens.py` (the same shards for the
same batches and weights, read by the same `TokenDataset`), and a torch
loader around the reader.

Shard layout (one npz per shard, `shard_*.npz`):
  tokens         (n, cam, hw)   int16   stage-1 codebook indices
  cond_ids       (n, nc)        int16   BEV VQ-VAE indices
  intrinsics_inv (n, cam, 3, 3) float32
  extrinsics_inv (n, cam, 4, 4) float32
  sample_token   (n,)           str
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Iterator, List

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tokenize_dataset(pipe, loader: Iterable[Dict], out_dir: str,
                     shard_size: int = 1024) -> int:
    """Run the stage-1 encoders of `pipe` (a serving pipeline) over the
    batches of `loader` (numpy, or tensors from `datamodule.device_prefetch`)
    and write `shard_XXXXX.npz` files of about `shard_size` samples into
    `out_dir`. Returns the number of samples."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buf: List[Dict[str, np.ndarray]] = []
    shard_idx = 0

    def flush():
        nonlocal buf, shard_idx
        if not buf:
            return
        merged = {k: np.concatenate([b[k] for b in buf]) for k in buf[0]
                  if k != "sample_token"}
        tokens_list = sum((list(b["sample_token"]) for b in buf), [])
        np.savez_compressed(out / f"shard_{shard_idx:05d}.npz",
                            sample_token=np.asarray(tokens_list), **merged)
        shard_idx += 1
        buf = []

    n = 0
    for batch in loader:
        toks = pipe.encode_images(batch["image"])
        (seg,) = pipe.as_inputs(batch["segmentation"])
        cond = pipe.encode_bev(seg)
        buf.append({
            "tokens": _host(toks).astype(np.int16),
            "cond_ids": _host(cond).astype(np.int16),
            "intrinsics_inv": _host(batch["intrinsics_inv"]),
            "extrinsics_inv": _host(batch["extrinsics_inv"]),
            "sample_token": batch["sample_token"],
        })
        n += len(batch["sample_token"])
        if sum(len(b["sample_token"]) for b in buf) >= shard_size:
            flush()
    flush()
    return n


class TokenDataset:
    """Loads token shards fully into RAM (they are small) and serves
    stage-2 training samples."""

    def __init__(self, shard_dir: str):
        shards = sorted(Path(shard_dir).glob("shard_*.npz"))
        if not shards:
            raise FileNotFoundError(f"no shards in {shard_dir}")
        parts = [dict(np.load(s, allow_pickle=False)) for s in shards]
        self.tokens = np.concatenate([p["tokens"] for p in parts])
        self.cond_ids = np.concatenate([p["cond_ids"] for p in parts])
        self.intrinsics_inv = np.concatenate(
            [p["intrinsics_inv"] for p in parts])
        self.extrinsics_inv = np.concatenate(
            [p["extrinsics_inv"] for p in parts])
        self.sample_token = np.concatenate(
            [p["sample_token"] for p in parts])

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {
            "tokens": self.tokens[idx].astype(np.int32),
            "cond_ids": self.cond_ids[idx].astype(np.int32),
            "intrinsics_inv": self.intrinsics_inv[idx],
            "extrinsics_inv": self.extrinsics_inv[idx],
            "sample_token": str(self.sample_token[idx]),
        }


def token_loader(dataset: TokenDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0) -> torch.utils.data.DataLoader:
    """A DataLoader of training batches (tensors, plus the list of sample
    tokens); the shuffle order comes from a generator seeded with `seed`."""
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
        num_workers=num_workers,
        generator=torch.Generator().manual_seed(seed) if shuffle else None)


def epochs(loader: torch.utils.data.DataLoader, num_cams: int
           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of `loader` without end, tokens as (b, cam, hw), without the
    sample tokens."""
    while True:
        for batch in loader:
            batch = dict(batch)
            batch.pop("sample_token", None)
            batch["tokens"] = batch["tokens"].reshape(
                batch["tokens"].shape[0], num_cams, -1)
            yield batch
