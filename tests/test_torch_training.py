"""Stage-2 training of the PyTorch port against the JAX reference at
tiny_test, fp32 on the CPU, on the same weights: `maskgit_loss` and its
parameter gradients, the optimizer (warm-up, clipping, decay partition,
lr 0 on the first update), the decay mask, the schedule and the EMA, one
whole train step; and, port-side, `skip_nonfinite`, accumulation, the
checkpoint manager and the CLI with save and resume.

Random draws cannot match between the two frameworks, so the tests fix
them: the mask is handed to both sides (`mask_override`), cond_drop_prob
is 0 or 1 so cond_keep is the same, the JAX test's `gumbel_sample` is
monkeypatched to an argmax and the port gets zero gumbel noise. Nothing in
`bevgen_tpu` changes.
"""
import copy
import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_tpu.training import optim as joptim
from bevgen_tpu.training import trainer as jtrainer
from bevgen_torch.core.convert import export_jax_params
from bevgen_torch.models.stage2 import maskgit as tmg
from bevgen_torch.training import optim as toptim
from bevgen_torch.training import trainer as ttrainer
from bevgen_torch.training.checkpoints import CheckpointManager
from torch_parity import (assert_steps_close, assert_trees_close,
                          tiny_configs, tiny_pipelines)

# fp32 on both sides. Loss values: 1e-5 absolute (sums in another order).
# Gradients: 1e-5 of each leaf's largest entry (at least 1e-6 absolute):
# the same chain of fp32 products, summed in another order.
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
B = 2


def _batch(seed=0):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    _, tc = tiny_configs()
    tf = tc.transformer
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tf.vocab_size, (B, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    mask = rng.uniform(size=tokens.shape) < 0.5
    mask[..., 0] = True
    return {"tokens": tokens, "cond_ids": cond, "intrinsics_inv": np.asarray(ii),
            "extrinsics_inv": np.asarray(ei)}, mask


def _jbatch(batch):
    return {"tokens": jnp.asarray(batch["tokens"], jnp.int32),
            "cond_ids": jnp.asarray(batch["cond_ids"], jnp.int32),
            "intrinsics_inv": jnp.asarray(batch["intrinsics_inv"]),
            "extrinsics_inv": jnp.asarray(batch["extrinsics_inv"])}


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _models(cond_drop_prob=0.0):
    """(jax MaskGit, jax maskgit params {'params': ...}, port MaskGit) on
    the same weights, with cond_drop_prob set on both."""
    jp, params, tp = tiny_pipelines()
    jmuse = dataclasses.replace(jp.maskgit.muse, cond_drop_prob=cond_drop_prob)
    jmodel = jmg.MaskGit(jp.maskgit.cfg, jmuse, jnp.float32)
    tmodel = copy.deepcopy(tp.maskgit)
    tmodel.muse = dataclasses.replace(tmodel.muse, cond_drop_prob=cond_drop_prob)
    return jmodel, params["maskgit"], tmodel


@pytest.fixture
def argmax_gumbel(monkeypatch):
    monkeypatch.setattr(jmg, "gumbel_sample",
                        lambda rng, logits, temp: jnp.argmax(logits, axis=-1))


def _zero_gumbel(model, tokens):
    return torch.zeros(tuple(tokens.shape) + (model.cfg.vocab_size,))


@pytest.mark.parametrize("cond_drop_prob", [0.0, 1.0])
def test_maskgit_loss_and_grads_match_jax(cond_drop_prob, argmax_gumbel):
    jmodel, jparams, tmodel = _models(cond_drop_prob)
    batch, mask = _batch(1)
    jb = _jbatch(batch)

    def f(p):
        out = jmg.maskgit_loss(jmodel, {"params": p}, jax.random.PRNGKey(0),
                               jb["tokens"], jb["cond_ids"],
                               jb["intrinsics_inv"], jb["extrinsics_inv"],
                               mask_override=jnp.asarray(mask))
        return out.loss, out

    (_, want), jgrads = jax.value_and_grad(f, has_aux=True)(jparams["params"])
    tb = _tbatch(batch)
    out = tmg.maskgit_loss(tmodel, tb["tokens"], tb["cond_ids"],
                           tb["intrinsics_inv"], tb["extrinsics_inv"],
                           generator=torch.Generator().manual_seed(0),
                           mask_override=torch.from_numpy(mask),
                           gumbel_noise=_zero_gumbel(tmodel, tb["tokens"]))
    for name in ("loss", "ce_loss", "critic_loss"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(want, name)), atol=LOSS_TOL,
                                   rtol=0, err_msg=name)
    assert float(out.critic_loss.detach()) > 0
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(out.loss, [p for _, p in tmodel.named_parameters()])
    assert_trees_close(export_jax_params(tmodel, dict(zip(names, grads))),
                        jgrads, GRAD_RTOL, what="grad")


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    labels = rng.integers(-1, 7, (2, 3, 5))
    want = float(jmg.masked_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = float(tmg.masked_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6


def test_decay_mask_matches_jax():
    _, jparams, tmodel = _models()
    flags = toptim.decay_mask(tmodel)
    assert any(flags.values()) and not all(flags.values())
    exported = export_jax_params(tmodel, {
        n: torch.full_like(p, float(flags[n])) for n, p in tmodel.named_parameters()})
    want = joptim.decay_mask(jparams["params"])
    got = jax.tree_util.tree_map(lambda a: bool(a.flat[0]), exported)
    assert got == want


def test_warmup_cosine_matches_jax():
    ours = toptim.warmup_cosine(3e-4, 3, 10, min_lr=1e-5)
    ref = joptim.warmup_cosine(3e-4, 3, 10, min_lr=1e-5)
    for step in range(14):
        assert abs(ours(step) - float(ref(step))) <= 1e-10, step
    assert ours(0) == 0.0


@pytest.mark.parametrize("warmup", [False, True])
def test_ema_matches_jax(warmup):
    _, jparams, tmodel = _models()
    state = toptim.ema_init(tmodel)
    jstate = joptim.ema_init(jparams["params"])
    rng = np.random.default_rng(3)
    for _ in range(2):
        with torch.no_grad():
            for p in tmodel.parameters():
                p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        toptim.ema_update(state, tmodel, 0.9, warmup=warmup)
        jstate = joptim.ema_update(jstate, export_jax_params(tmodel), 0.9,
                                   warmup=warmup)
    assert state.count == int(jstate.count) == 2
    ema_model = copy.deepcopy(tmodel)
    assert_trees_close(export_jax_params(ema_model, state.params),
                        jstate.params, 1e-6, what="ema")


def test_optimizer_matches_optax():
    """Three updates of the same gradients: the first has lr 0 (warm-up
    count 0), the first and third are clipped (global norm 3 and 2 > 1),
    the second is not (0.5); Linear weights decay, the rest does not."""
    _, jparams, tmodel = _models()
    tx = joptim.maskgit_optimizer(1e-2, warmup_steps=2, total_steps=10,
                                  params_example=jparams["params"])
    jp = jax.tree_util.tree_map(jnp.asarray, jparams["params"])
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    opt = toptim.maskgit_optimizer(tmodel, 1e-2, warmup_steps=2, total_steps=10)
    names = [n for n, _ in tmodel.named_parameters()]
    rng = np.random.default_rng(4)
    for norm in (3.0, 0.5, 2.0):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                 for p in opt.params]
        scale = norm / float(toptim.global_norm(grads))
        grads = [g * scale for g in grads]
        jgrads = export_jax_params(tmodel, dict(zip(names, grads)))
        updates, jstate = update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = export_jax_params(tmodel)
        assert opt.step(grads)
        after = export_jax_params(tmodel)
        if opt.count == 1:  # lr 0: nothing moves
            assert_trees_close(after, before, 0.0, atol_min=0.0, what="lr0")
        # Adam steps of ~lr per entry: 1e-6 absolute is 1e-4 of one step
        assert_trees_close(after, jp, 0.0, atol_min=1e-6,
                            what=f"params after update {opt.count}")


def test_accumulation_equals_one_mean_gradient_update():
    """k micro-batches through the accumulating optimizer == one update
    with their mean gradient (the gradient of the k-times batch for a
    mean loss); nothing moves before the k-th."""
    _, _, tmodel = _models()
    twin = copy.deepcopy(tmodel)
    acc = toptim.maskgit_optimizer(tmodel, 1e-2, warmup_steps=1,
                                   total_steps=10, accumulate_steps=3)
    ref = toptim.maskgit_optimizer(twin, 1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(5)
    for cycle in range(2):
        micro = [[torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                  for p in acc.params] for _ in range(3)]
        start = [p.detach().clone() for p in acc.params]
        assert not acc.step(micro[0]) and not acc.step(micro[1])
        assert all(torch.equal(a, b) for a, b in zip(start, acc.params))
        assert acc.step(micro[2])
        assert ref.step([(a + b + c) / 3 for a, b, c in zip(*micro)])
        for a, b in zip(acc.params, ref.params):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert acc.count == ref.count == 2


def test_train_step_matches_jax(monkeypatch, argmax_gumbel):
    """Two whole train steps (loss, grads, clip, AdamW, EMA) against the
    reference's make_train_step with the same fixed mask. The first update
    has lr 0; the second moves each entry by about lr = 1e-3."""
    jmodel, jparams, tmodel = _models()
    batch, mask = _batch(6)
    monkeypatch.setattr(jtrainer, "maskgit_loss",
                        partial(jmg.maskgit_loss, mask_override=jnp.asarray(mask)))
    tx = joptim.maskgit_optimizer(1e-3, warmup_steps=1, total_steps=10,
                                  params_example=jparams["params"])
    jstate = jtrainer.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, jparams), tx)
    jstep = jax.jit(jtrainer.make_train_step(jmodel, tx, ema_decay=0.9))
    opt = toptim.maskgit_optimizer(tmodel, 1e-3, warmup_steps=1, total_steps=10)
    state = ttrainer.create_train_state(tmodel, opt)
    step = ttrainer.make_train_step(ema_decay=0.9)
    jb, tb = _jbatch(batch), _tbatch(batch)
    for i in range(2):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i))
        m = step(state, tb, torch.Generator().manual_seed(i),
                 mask_override=torch.from_numpy(mask),
                 gumbel_noise=_zero_gumbel(tmodel, tb["tokens"]))
        for key in ("loss", "ce_loss", "critic_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       atol=LOSS_TOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        assert float(m["update_applied"]) == float(jm["update_applied"]) == 1.0
    assert state.step == int(jstate.step) == 2 and opt.count == 2
    assert_steps_close(export_jax_params(tmodel), jstate.params["params"],
                        1e-3, "params")
    assert_steps_close(export_jax_params(copy.deepcopy(tmodel),
                                          state.ema.params),
                        jstate.ema.params, 1e-3, "ema")


def test_skip_nonfinite_keeps_params_and_optimizer():
    _, _, tmodel = _models()
    batch, mask = _batch(7)
    opt = toptim.maskgit_optimizer(tmodel, 1e-3, warmup_steps=1, total_steps=10)
    state = ttrainer.create_train_state(tmodel, opt)
    step = ttrainer.make_train_step()
    bad = _tbatch(batch)
    bad["intrinsics_inv"] = bad["intrinsics_inv"] * float("nan")
    before = [p.detach().clone() for p in opt.params]
    m = step(state, bad, torch.Generator().manual_seed(0))
    assert float(m["update_applied"]) == 0.0
    assert not np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    assert opt.count == 0 and state.step == 1 and not opt.adam.state
    for _ in range(2):  # the first good update has lr 0
        m = step(state, _tbatch(batch), torch.Generator().manual_seed(1))
        assert float(m["update_applied"]) == 1.0
    assert opt.count == 2
    assert any(not torch.equal(a, b) for a, b in zip(before, opt.params))


def test_ema_advances_once_per_accumulated_update():
    _, _, tmodel = _models()
    batch, _ = _batch(8)
    opt = toptim.maskgit_optimizer(tmodel, 1e-3, warmup_steps=1,
                                   total_steps=10, accumulate_steps=2)
    state = ttrainer.create_train_state(tmodel, opt)
    step = ttrainer.make_train_step(ema_every=2)
    for i in range(4):
        step(state, _tbatch(batch), torch.Generator().manual_seed(i))
    assert state.step == 4 and opt.count == 2 and state.ema.count == 2


def _write_shard(path, tf, n, seed):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    ii, ei = canonical_rig_inverses(tf, n)
    np.savez(path, tokens=rng.integers(0, tf.vocab_size, (
                 n, tf.num_cams, tf.num_cam_tokens)).astype(np.int16),
             cond_ids=rng.integers(0, tf.cond_vocab_size,
                                   (n, tf.num_cond_tokens)).astype(np.int16),
             intrinsics_inv=np.asarray(ii, np.float32),
             extrinsics_inv=np.asarray(ei, np.float32),
             sample_token=np.asarray([f"s{i}" for i in range(n)]))


def _run_cli(argv, capsys):
    from bevgen_torch.scripts import train_stage2
    assert train_stage2.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done"
    return lines


def test_cli_fake_two_steps_saves_and_resumes(tmp_path, capsys):
    ck = tmp_path / "ck"
    base = ["preset=tiny_test", "device=cpu", "batch_size=2", "log_every=1",
            "warmup_steps=1", f"ckpt_dir={ck}"]
    lines = _run_cli(base + ["steps=2"], capsys)
    logs = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["step"] for r in logs] == [1, 2]
    for r in logs:
        assert {"loss", "ce_loss", "critic_loss", "grad_norm", "update_applied",
                "steps_per_sec"} <= r.keys()
        assert np.isfinite(r["loss"]) and r["update_applied"] == 1.0
    assert (ck / "LATEST").read_text() == "step_00000002"
    assert (ck / "step_00000002-EMA" / "params.pt").exists()
    saved = torch.load(ck / "step_00000002" / "state.pt", weights_only=False)
    assert saved["step"] == 2 and saved["optimizer"]["count"] == 2

    lines = _run_cli(base + ["steps=3"], capsys)
    assert any(x.startswith("resumed from") and "step 2" in x for x in lines)
    logs = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["step"] for r in logs] == [3]
    assert (ck / "LATEST").read_text() == "step_00000003"


def test_cli_token_shards_with_validation(tmp_path, capsys):
    _, tc = tiny_configs()
    for d, seed in (("train", 0), ("val", 1)):
        (tmp_path / d).mkdir()
        _write_shard(tmp_path / d / "shard_00000.npz", tc.transformer, 5, seed)
    lines = _run_cli(["preset=tiny_test", "device=cpu", "batch_size=2",
                      "steps=2", "log_every=1", f"tokens_dir={tmp_path / 'train'}",
                      f"val_tokens_dir={tmp_path / 'val'}", "eval_every=2"],
                     capsys)
    val = [json.loads(x) for x in lines if x.startswith("{") and "val_ce" in x]
    assert len(val) == 1 and np.isfinite(val[0]["val_ce"]) and val[0]["val_ema"]


def test_cli_refuses_a_mesh():
    """In one process: mesh axes above 1 need torchrun's ranks
    (`scripts/cli.py:pop_mesh`)."""
    from bevgen_torch.scripts import train_stage2
    for arg, message in (("dp=2", "ranks in one process; start one process "
                                  "per rank with torchrun"),
                         ("tp=2", "tp=2: 2 ranks in one process; start one "
                                  "process per rank with torchrun"),
                         ("dcn=2", "ranks in one process; start one process "
                                   "per rank with torchrun")):
        with pytest.raises(SystemExit, match=message):
            train_stage2.main(["preset=tiny_test", "device=cpu", arg])


def test_checkpoint_manager_prunes_and_keeps_latest(tmp_path):
    _, _, tmodel = _models()
    opt = toptim.maskgit_optimizer(tmodel, 1e-3)
    state = ttrainer.create_train_state(tmodel, opt)
    mgr = CheckpointManager(str(tmp_path), interval_minutes=1e9, keep_last=2)
    assert not mgr.save_step(1, state)          # interval not reached
    for s in (1, 2, 3):
        state.step = s
        assert mgr.save_step(s, state, force=True)
        mgr.save_ema(s, state.ema.params)
    tags = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert tags == ["step_00000002", "step_00000002-EMA", "step_00000003",
                    "step_00000003-EMA"]
    fresh = ttrainer.create_train_state(copy.deepcopy(tmodel), toptim.maskgit_optimizer(
        copy.deepcopy(tmodel), 1e-3))
    assert mgr.restore_latest(fresh).name == "step_00000003"
    assert fresh.step == 3 and fresh.ema.params.keys() == state.ema.params.keys()


def test_fp32_storage_computes_what_bf16_storage_computes():
    """param_dtype only moves where the weights live: with weights that bf16
    holds exactly, fp32 storage cast at use gives bit-identical bf16
    logits (serving keeps param_dtype = dtype)."""
    from bevgen_torch.models.init import init_weights
    _, tc = tiny_configs()
    tf = tc.transformer
    stored = tmg.MaskGit(tf, tc.muse, dtype=torch.bfloat16)
    init_weights(stored, 3)
    master = tmg.MaskGit(tf, tc.muse, dtype=torch.bfloat16,
                         param_dtype=torch.float32)
    master.load_state_dict({k: v.float() for k, v in stored.state_dict().items()})
    assert master.transformer.to_logits.weight.dtype == torch.float32
    assert stored.transformer.to_logits.weight.dtype == torch.bfloat16
    batch, _ = _batch(9)
    tb = _tbatch(batch)
    args = (tb["tokens"], tb["cond_ids"], tb["intrinsics_inv"],
            tb["extrinsics_inv"])
    with torch.no_grad():
        a, b = stored(*args), master(*args)
    assert a.logits.dtype == b.logits.dtype == torch.bfloat16
    assert torch.equal(a.logits, b.logits)
