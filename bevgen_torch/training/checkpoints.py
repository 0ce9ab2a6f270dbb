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
"""
from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

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
                 keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.interval_s = interval_minutes * 60.0
        self.keep_last = keep_last
        self._last_save = time.monotonic()

    def _write(self, tag: str, filename: str, payload: Any,
               update_latest: bool) -> None:
        path = self.dir / tag
        tmp = self.dir / (tag + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(_cpu(payload), tmp / filename)
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
        if update_latest:
            (self.dir / "LATEST").write_text(tag)

    def save_step(self, step: int, state, force: bool = False) -> bool:
        """Save `state` (a trainer.TrainState) once the wall-clock interval
        has passed since the last save, or now with force=True. Returns
        whether it saved."""
        now = time.monotonic()
        if not force and now - self._last_save < self.interval_s:
            return False
        self._write(f"step_{step:08d}", STATE_FILE,
                    {"params": state.model.state_dict(),
                     "optimizer": state.optimizer.state_dict(),
                     "step": int(state.step)}, update_latest=True)
        self._last_save = now
        self._prune()
        return True

    def save_ema(self, step: int, ema_params: Dict[str, torch.Tensor]) -> None:
        self._write(f"step_{step:08d}-EMA", EMA_FILE, dict(ema_params),
                    update_latest=False)

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
