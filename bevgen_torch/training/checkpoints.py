"""Checkpoints of stage-2 training: wall-clock-interval saves, an `-EMA`
sibling, pruning, resume.

Counterpart of `bevgen_tpu/training/checkpoints.py:CheckpointManager`. The
format is the port's own and differs from the reference's orbax tree:
each tag `step_XXXXXXXX/` holds one `state.pt` written by `torch.save`,
{"params": model.state_dict(), "optimizer": optimizer.state_dict(),
"step": int}, and its sibling `step_XXXXXXXX-EMA/` one `params.pt` with
the EMA parameters by name. `LATEST` names the tag to resume from; EMA
siblings never own it. To hand port-trained weights to the reference,
convert the parameters with `core/convert.py:export_jax_params`.

`async_save=True` (the reference's `CheckpointManager(async_save=)`) moves
`torch.save`, the rename into place, `LATEST` and the pruning to one
background thread. The host snapshot stays synchronous: the next optimizer
step updates parameters and moments in place. At most one write is in
flight (a save joins the previous one first), a write's exception re-raises
on the next join or on `wait()`, and `latest()`/`restore_latest()` join
before they read. `save_step(..., ema=)` writes the tag's `-EMA` sibling in
the same job, so an asynchronous loop pays the two snapshots and not the
step's write.

With a `mesh` (data-parallel training, `parallel/sharding.py`) every rank
calls `save_step` on the same steps: whether an interval save is due is
agreed over the ranks, the optimizer's and the EMA's ZeRO slices are
gathered into the unsliced layout (a collective), and only rank 0 writes
(the JAX manager's `_is_writer`). Every rank restores from the same tag;
the slices are cut again for the restoring run's ranks, so a tag restores
at any rank count. Under tensor parallelism every tp slice (parameters,
moments, EMA) is gathered and joined by meaning (`parallel/tensor.py`)
before the write, so a tag holds the one-process layout whatever the tp.

`load_weights` (counterpart of `bevgen_tpu/training/checkpoints.py:
load_weights` :193) fills a serving pipeline from a checkpoint: the
reference's torch checkpoints through `core/checkpoint.py`'s converters,
or the port's own tags; `resolve_ema_path` (:146) finds a tag's `-EMA`
sibling.
"""
from __future__ import annotations

import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from bevgen_torch.parallel.tensor import full_state_dict

STATE_FILE = "state.pt"
EMA_FILE = "params.pt"


def _cpu(tree: Any) -> Any:
    """A host copy of a nested state (tensors cloned to the CPU)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, interval_minutes: float = 30.0,
                 keep_last: int = 3, async_save: bool = False, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.interval_s = interval_minutes * 60.0
        self.keep_last = keep_last
        self._last_save = time.monotonic()
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt-writer")
                      if async_save else None)
        self._pending: Optional[Future] = None

    def _write(self, tag: str, filename: str, payload: Any,
               update_latest: bool) -> None:
        path = self.dir / tag
        tmp = self.dir / (tag + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / filename)
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
        if update_latest:
            (self.dir / "LATEST").write_text(tag)

    def _run(self, jobs: List[Tuple[str, str, Any, bool]], prune: bool) -> None:
        for job in jobs:
            self._write(*job)
        if prune:
            self._prune()

    def _submit(self, jobs: List[Tuple[str, str, Any, bool]],
                prune: bool) -> None:
        """Write `jobs` ((tag, file, host snapshot, update LATEST), in
        order), then prune: now, or on the writer thread once the previous
        write has been joined."""
        if self._pool is None:
            self._run(jobs, prune)
            return
        self.wait()
        self._pending = self._pool.submit(self._run, jobs, prune)

    def wait(self) -> None:
        """Join the write in flight, if any, and re-raise its exception."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def save_step(self, step: int, state, force: bool = False,
                  ema=None) -> bool:
        """Save `state` (a trainer.TrainState) once the wall-clock interval
        has passed since the last save, or now with force=True; with `ema`
        (parameters by name, or an `optim.EmaState`), its `-EMA` sibling in
        the same job. Returns whether it saved. With a mesh every rank calls
        it on every step."""
        from bevgen_torch.training.optim import EmaState
        now = time.monotonic()
        due = force or now - self._last_save >= self.interval_s
        if self.mesh is not None:
            due = self.mesh.any(due)
        if not due:
            return False
        tag = f"step_{step:08d}"
        snapshot = {"params": full_state_dict(state.model, self.mesh),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step)}
        if isinstance(ema, EmaState):
            ema = ema.full()
        if self.writer:
            jobs = [(tag, STATE_FILE, _cpu(snapshot), True)]
            if ema is not None:
                jobs.append((tag + "-EMA", EMA_FILE, _cpu(dict(ema)), False))
            self._submit(jobs, prune=True)
        self._last_save = now
        return True

    def save_ema(self, step: int, ema_params: Dict[str, torch.Tensor]) -> None:
        if not self.writer:
            return
        self._submit([(f"step_{step:08d}-EMA", EMA_FILE,
                       _cpu(dict(ema_params)), False)], prune=False)

    def _prune(self) -> None:
        tags = sorted(p.name for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(("-EMA", ".tmp")))
        marker = self.dir / "LATEST"
        latest = marker.read_text().strip() if marker.exists() else None
        # never the tag LATEST points to (a fresh run's low tag can sort
        # before stale higher ones left in the directory)
        doomed = [t for t in tags if t != latest][
            :max(0, len(tags) - self.keep_last)]
        for t in doomed:
            shutil.rmtree(self.dir / t, ignore_errors=True)
            shutil.rmtree(self.dir / (t + "-EMA"), ignore_errors=True)

    def latest(self) -> Optional[Path]:
        self.wait()
        marker = self.dir / "LATEST"
        if marker.exists():
            tag = self.dir / marker.read_text().strip()
            if (tag / STATE_FILE).exists():
                return tag
        return None

    def restore_latest(self, state) -> Optional[Path]:
        """Load the LATEST tag into `state` (parameters, optimizer state,
        step) and its EMA from the `-EMA` sibling when there is one, else
        from the restored parameters. Returns the tag, or None when there
        is nothing to resume."""
        from bevgen_torch.training import optim
        tag = self.latest()
        if tag is None:
            return None
        saved = torch.load(tag / STATE_FILE, map_location="cpu",
                           weights_only=False)
        state.model.load_state_dict(saved["params"])
        dev = next(state.model.parameters()).device
        state.optimizer.load_state_dict(saved["optimizer"])
        if state.optimizer.acc is not None:
            state.optimizer.acc = [a.to(dev) for a in state.optimizer.acc]
        state.step = int(saved["step"])
        ema_file = tag.with_name(tag.name + "-EMA") / EMA_FILE
        if ema_file.exists():
            ema = torch.load(ema_file, map_location="cpu", weights_only=True)
            state.ema = optim.EmaState({n: t.to(dev) for n, t in ema.items()})
        else:
            state.ema = optim.ema_init(state.model)
        return tag


def resolve_ema_path(path: str) -> str:
    """The `-EMA` sibling of one of the port's tags (the reference swaps the
    EMA weights in for evaluation, modules/stage2/ema.py:94-146): a tag
    `step_XXXXXXXX` resolves to `step_XXXXXXXX-EMA`, a run directory to the
    sibling of the tag `LATEST` names, else of its newest `step_*` tag, and
    an `-EMA` directory to itself. Raises FileNotFoundError when there is no
    such sibling: serving the plain weights when the EMA ones were asked for
    would be a silent change of model."""
    p = Path(path)
    if p.name.endswith("-EMA"):
        ema = p
    elif p.is_dir() and p.name.startswith("step_"):
        ema = p.with_name(p.name + "-EMA")
    elif p.is_dir():
        marker = p / "LATEST"
        if marker.exists():
            tag = marker.read_text().strip()
        else:
            tags = sorted(d.name for d in p.iterdir() if d.is_dir()
                          and d.name.startswith("step_")
                          and not d.name.endswith(("-EMA", ".tmp")))
            if not tags:
                raise FileNotFoundError(f"no step_* checkpoints in {p}")
            tag = tags[-1]
        ema = p / (tag + "-EMA")
    else:
        raise FileNotFoundError(
            f"ema=true needs a checkpoint directory of the port, got {path}")
    if not (ema / EMA_FILE).is_file():
        raise FileNotFoundError(f"no EMA checkpoint {ema / EMA_FILE} for {path}")
    return str(ema)


def _port_file(p: Path) -> Optional[Path]:
    """The port's own checkpoint file at `p` (a tag directory or the file
    itself), or None."""
    for name in (STATE_FILE, EMA_FILE):
        if p.name == name and p.is_file():
            return p
        if p.is_dir() and (p / name).is_file():
            return p / name
    return None


def load_weights(path: str, pipeline: nn.Module) -> str:
    """Fill `pipeline` (a `BEVGenPipeline` or an `ARPipeline`) with the
    weights at `path` and return the checkpoint's family.

    * The port's own tags (a `step_*` directory or its `state.pt`, whose
      `params` the trainer wrote; an `-EMA` sibling or its `params.pt`) fill
      the pipeline's `maskgit`, strictly: "port" or "port-ema".
    * The reference's torch checkpoints (`.ckpt`, `.pt`, `.pth` files and
      DeepSpeed ZeRO directories, `core/checkpoint.py:load_torch_checkpoint`)
      are routed by key prefix, as the reference routes them: `maskgit.*` to
      `convert_net2net` ("muse"), top-level `transformer.*` to
      `convert_ar_net2net` ("ar"), bare `encoder.`/`decoder.`/`quantize.`
      to `convert_stage1`, grafted into the pipeline's `first_stage` with
      every other part kept ("stage1"). Any other family raises ValueError.

    Whether the MUSE converter keeps the `self_cond_to_init_embed.*` keys
    that every reference checkpoint holds is read from the pipeline, as the
    reference reads its example tree (:185): only a pipeline that holds the
    module takes them. A converted tree is loaded by
    `core/convert.py:load_jax_params`, which raises KeyError naming any leaf
    the pipeline cannot hold (a TokenCritic's, or `self_cond_to_init_embed`'s
    for a pipeline built without them) and any parameter the checkpoint
    leaves unset."""
    from bevgen_torch.core import checkpoint as ckpt_io
    from bevgen_torch.core.convert import export_jax_params, load_jax_params
    p = Path(path)
    own = _port_file(p)
    if own is not None:
        if not isinstance(getattr(pipeline, "maskgit", None), nn.Module):
            raise ValueError(f"{own} holds MaskGit parameters (the port's "
                             f"trainer's); the pipeline has no maskgit")
        saved = torch.load(own, map_location="cpu", weights_only=False)
        params = saved["params"] if own.name == STATE_FILE else saved
        pipeline.maskgit.load_state_dict(params, strict=True)
        return "port" if own.name == STATE_FILE else "port-ema"
    state = ckpt_io.load_torch_checkpoint(str(p))
    keys = list(state)
    if any(k.startswith("maskgit.") for k in keys):
        self_cond = any("self_cond_to_init_embed" in name
                        for name, _ in pipeline.named_parameters())
        load_jax_params(pipeline, ckpt_io.convert_net2net(state, self_cond))
        return "muse"
    if any(k.startswith("transformer.") for k in keys):
        load_jax_params(pipeline, ckpt_io.convert_ar_net2net(state))
        return "ar"
    if any(k.startswith(("encoder.", "decoder.", "quantize.")) for k in keys):
        tree = export_jax_params(pipeline)
        tree["first_stage"] = {"params": ckpt_io.convert_stage1(state)}
        load_jax_params(pipeline, tree)
        return "stage1"
    raise ValueError(f"unrecognized torch checkpoint family in {path}: "
                     f"sample keys {keys[:5]}")
