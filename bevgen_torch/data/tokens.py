"""Pre-tokenised stage-2 training data: the port's own copy of
`bevgen_tpu/data/tokens.py:TokenDataset` (numpy only), and a torch loader
around it.

Shard layout (one npz per shard, `shard_*.npz`):
  tokens         (n, cam, hw)   int16   stage-1 codebook indices
  cond_ids       (n, nc)        int16   BEV VQ-VAE indices
  intrinsics_inv (n, cam, 3, 3) float32
  extrinsics_inv (n, cam, 4, 4) float32
  sample_token   (n,)           str
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator

import numpy as np
import torch


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
