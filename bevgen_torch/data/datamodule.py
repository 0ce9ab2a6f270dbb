"""Batching & host->device pipeline.

The port's copy of `bevgen_tpu/data/datamodule.py`: the reference's
`DataModuleFromConfig` + DataLoader (dataloader/datamodule_from_config.py:
7-70) as a numpy-native loader with the JAX package's batch order
(`np.random.default_rng((seed, epoch))` per epoch, `drop_last` as there),
fixed static batch shapes, background worker threads for decode, and a
double-buffered device prefetcher (pinned host tensors, `non_blocking`
copies on a side stream) so the host-to-device copies overlap the card's
work.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

_ARRAY_KEYS = ("image", "segmentation", "intrinsics", "extrinsics",
               "intrinsics_inv", "extrinsics_inv", "tokens", "cond_ids")


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields, list the rest (torch default_collate
    equivalent for our batch schema)."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in _ARRAY_KEYS or isinstance(vals[0], np.ndarray):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class DataLoader:
    """Minimal deterministic loader: shuffle per epoch by seed, fetch
    with worker threads (jpeg decode releases the GIL in cv2), yield
    collated numpy batches with static shapes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 4,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        self.epoch += 1
        if self.num_workers == 0:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def producer(worker_id: int):
            try:
                for bi in range(worker_id, nb, self.num_workers):
                    if stop.is_set():
                        return
                    batch = collate([self.dataset[int(i)]
                                     for i in batches[bi]])
                    q.put((bi, batch))
            except BaseException as e:  # propagate instead of hanging
                q.put((-1, e))

        threads = [threading.Thread(target=producer, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Dict] = {}
            nxt = 0
            got = 0
            while got < nb:
                bi, batch = q.get()
                if bi < 0:
                    # a worker died — re-raise its exception here rather
                    # than blocking on q.get() forever
                    raise batch
                pending[bi] = batch
                got += 1
                while nxt in pending:
                    yield pending.pop(nxt)
                    nxt += 1
        finally:
            stop.set()
            # unblock producers stuck on a full queue so threads exit
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def to_tensors(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A batch's numeric numpy arrays as tensors on `device`; the other
    entries as they are. For a CUDA device each array is copied once into
    pinned host memory and sent with a `non_blocking` copy on the current
    stream; on the CPU it is copied once."""
    import torch
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            if device.type == "cuda":
                t = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = t.to(device, non_blocking=True)
            else:
                out[k] = torch.tensor(v, device=device)
        else:
            out[k] = v
    return out


def device_prefetch(it: Iterator[Dict[str, Any]], device, size: int = 2):
    """Keep `size` batches in flight to `device` (`to_tensors`). On a CUDA
    device the copies run on a side stream, so the next batch's copy
    overlaps the card's work on this one; a batch is handed over once the
    consuming stream waits for its copies."""
    import torch
    device = torch.device(device)
    stream = (torch.cuda.Stream(device) if device.type == "cuda" else None)
    buf: List = []

    def issue(batch):
        if stream is None:
            return to_tensors(batch, device), None
        with torch.cuda.stream(stream):
            out = to_tensors(batch, device)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def hand_over(entry):
        out, done = entry
        if done is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    # memory allocated on the side stream, used on this one
                    v.record_stream(current)
        return out

    for batch in it:
        buf.append(issue(batch))
        if len(buf) >= size:
            yield hand_over(buf.pop(0))
    while buf:
        yield hand_over(buf.pop(0))


class Subset:
    """Index-selected view of a dataset (torch.utils.data.Subset
    equivalent, used by the small_val knob)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class DataModule:
    """Train/val/test loader bundle (DataModuleFromConfig equivalent,
    incl. the smoke_test / small_val / mini_dataset knobs)."""

    def __init__(self, train=None, validation=None, test=None,
                 batch_size: int = 1, val_batch_size: Optional[int] = None,
                 num_workers: int = 4, seed: int = 0,
                 smoke_test: bool = False, small_val: bool = False):
        self.batch_size = 1 if smoke_test else batch_size
        self.val_batch_size = val_batch_size or self.batch_size
        self.num_workers = 0 if smoke_test else num_workers
        self.seed = seed
        self._train, self._val, self._test = train, validation, test
        self.small_val = small_val

    def train_dataloader(self):
        return DataLoader(self._train, self.batch_size, shuffle=True,
                          seed=self.seed, num_workers=self.num_workers)

    def val_dataloader(self):
        ds = self._val
        if self.small_val and ds is not None:
            # reference small_val: a fixed random subset of
            # 2 * batch_size validation samples
            # (datamodule_from_config.py:58-62)
            n = min(len(ds), 2 * self.val_batch_size)
            idx = np.random.default_rng(self.seed).choice(
                len(ds), size=n, replace=False)
            ds = Subset(ds, idx.tolist())
        # torch/reference default: validation keeps the partial final
        # batch (drop_last=False)
        return DataLoader(ds, self.val_batch_size, shuffle=False,
                          num_workers=self.num_workers, drop_last=False)

    def test_dataloader(self):
        return DataLoader(self._test, self.val_batch_size, shuffle=False,
                          num_workers=self.num_workers, drop_last=False)
