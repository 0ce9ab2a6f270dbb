"""Asynchronous checkpoint writes of the PyTorch port
(`training/checkpoints.py:CheckpointManager(async_save=True)`, the train
CLI's `ckpt_async=`), as the JAX package's tests hold its manager
(tests/test_preemption.py): a round trip with pruning, a snapshot that the
next optimizer step cannot reach, a writer's error surfacing on the next
join, and the CLI's tags complete when `main` returns, resumable and equal
to a synchronous run's bit for bit. On the CPU at tiny_test.
"""
import threading

import pytest
import torch

from bevgen_torch.core.config import tiny_test_config
from bevgen_torch.models.init import init_weights
from bevgen_torch.models.stage2.maskgit import MaskGit
from bevgen_torch.scripts import train_stage2
from bevgen_torch.scripts.train_stage2 import fake_batches
from bevgen_torch.training import checkpoints as ttc
from bevgen_torch.training import optim, trainer

JOIN_TIMEOUT_S = 60


def _state(seed=0):
    cfg = tiny_test_config()
    model = init_weights(MaskGit(cfg.transformer, cfg.muse), seed)
    return trainer.create_train_state(
        model, optim.maskgit_optimizer(model, 1e-3, warmup_steps=1))


def _fill(state, value):
    with torch.no_grad():
        for p in state.model.parameters():
            p.fill_(value)


def _tags(path):
    return sorted(p.name for p in path.iterdir() if p.is_dir())


@pytest.mark.parametrize("ema_in", ["save_ema", "save_step"])
def test_async_checkpoint_roundtrip_and_prune(tmp_path, ema_in):
    """keep_last=2 over three saves, the EMA written by `save_ema` after the
    step or in the step's job (`save_step(..., ema=)`)."""
    mgr = ttc.CheckpointManager(str(tmp_path), interval_minutes=0.0,
                                keep_last=2, async_save=True)
    state = _state()
    for step in (1, 2, 3):
        _fill(state, float(step))
        state.step = step
        ema = {n: torch.full_like(p, -step)
               for n, p in state.model.named_parameters()}
        if ema_in == "save_ema":
            assert mgr.save_step(step, state)
            mgr.save_ema(step, ema)
        else:
            assert mgr.save_step(step, state, ema=ema)
    mgr.wait()
    assert _tags(tmp_path) == ["step_00000002", "step_00000002-EMA",
                               "step_00000003", "step_00000003-EMA"]
    fresh = _state(seed=1)
    assert mgr.restore_latest(fresh) == tmp_path / "step_00000003"
    assert fresh.step == 3
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, torch.full_like(p, 3.0)), n
        assert torch.equal(fresh.ema.params[n], torch.full_like(p, -3.0)), n


def test_async_checkpoint_snapshot_isolated_from_mutation(tmp_path,
                                                          monkeypatch):
    """The host snapshot is taken in `save_step`: an optimizer step right
    after it (parameters and Adam moments updated in place) must not reach
    the file. The write is held until the step has run."""
    stepped = threading.Event()
    real_save = torch.save

    def held_save(obj, f, *args, **kwargs):
        assert stepped.wait(JOIN_TIMEOUT_S)
        return real_save(obj, f, *args, **kwargs)
    monkeypatch.setattr(ttc.torch, "save", held_save)
    state = _state()
    cfg = state.model.cfg
    step = trainer.make_train_step()
    batch = {k: torch.as_tensor(v)
             for k, v in next(fake_batches(cfg, 2, seed=0)).items()}
    gen = torch.Generator().manual_seed(0)
    step(state, batch, gen)                       # Adam's moments exist
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    adam = state.optimizer.adam
    first = adam.param_groups[0]["params"][0]    # index 0 of its state_dict
    moments = {k: v.clone() for k, v in adam.state[first].items()}
    mgr = ttc.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save_step(1, state, force=True, ema=state.ema.params)
    step(state, batch, gen)                       # mutates in place
    stepped.set()
    mgr.wait()
    saved = torch.load(tmp_path / "step_00000001" / ttc.STATE_FILE,
                       weights_only=False)
    moved = 0
    for n, p in state.model.named_parameters():
        assert torch.equal(saved["params"][n], before[n]), n
        moved += not torch.equal(p, before[n])
    assert moved > 0
    for k, v in moments.items():
        assert torch.equal(saved["optimizer"]["adam"]["state"][0][k], v), k
        assert not torch.equal(adam.state[first][k], v), k


def test_async_checkpoint_error_surfaces_on_join(tmp_path, monkeypatch):
    """A writer's exception re-raises on `wait()`, then on the next save's
    join; each is raised once, and the manager stays usable."""
    def boom(obj, f, *args, **kwargs):
        raise OSError("disk full")
    real_save = torch.save
    monkeypatch.setattr(ttc.torch, "save", boom)
    state = _state()
    mgr = ttc.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save_step(1, state, force=True)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                    # consumed
    mgr.save_step(2, state, force=True)
    with pytest.raises(OSError, match="disk full"):
        mgr.save_step(3, state, force=True)       # the join before it
    mgr.wait()
    monkeypatch.setattr(ttc.torch, "save", real_save)
    assert mgr.save_step(4, state, force=True, ema=state.ema.params)
    assert mgr.latest() == tmp_path / "step_00000004"
    assert (tmp_path / "step_00000004-EMA" / ttc.EMA_FILE).is_file()


def _cli(tmp, steps, mode):
    return train_stage2.main([
        "preset=tiny_test", "device=cpu", f"steps={steps}", "batch_size=2",
        "log_every=1", "ckpt_minutes=0", f"ckpt_async={mode}",
        f"ckpt_dir={tmp}"])


def _tag_tensors(tag):
    state = torch.load(tag / ttc.STATE_FILE, weights_only=False)
    ema = torch.load(tag.with_name(tag.name + "-EMA") / ttc.EMA_FILE,
                     weights_only=True)
    return state, ema


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_train_cli_async_checkpoints_resume_and_equal_sync(tmp_path, capsys):
    """`ckpt_async=true`: both steps save, the final tag is complete when
    `main` returns, equal bit for bit to a `ckpt_async=false` run's, and a
    rerun resumes from it."""
    sync, asyn = tmp_path / "sync", tmp_path / "async"
    assert _cli(sync, 2, "false") == 0
    assert _cli(asyn, 2, "true") == 0
    capsys.readouterr()
    for run in (sync, asyn):
        assert _tags(run) == ["step_00000001", "step_00000001-EMA",
                              "step_00000002", "step_00000002-EMA"]
        assert (run / "LATEST").read_text() == "step_00000002"
    want, got = (_tag_tensors(run / "step_00000002") for run in (sync, asyn))
    assert _equal(got, want)
    assert got[0]["step"] == 2
    assert _cli(asyn, 3, "true") == 0
    assert f"resumed from {asyn / 'step_00000002'} at step 2" in \
        capsys.readouterr().out
    assert (asyn / "LATEST").read_text() == "step_00000003"
    assert _tag_tensors(asyn / "step_00000003")[0]["step"] == 3
