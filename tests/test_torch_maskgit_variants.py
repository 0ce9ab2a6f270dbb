"""The MUSE model variants of the PyTorch port against the JAX reference at
tiny_test, fp32 on the CPU, on one numpy weight tree per variant: real
classifier-free guidance (`muse.real_cfg`), the TokenCritic transformer
(`muse.token_critic`), self-conditioning (`transformer.self_cond`) and
their combinations, and the per-step trajectory of `generate`.

Held to the JAX package: the tree shapes, `cfg_logits`/`cfg_critic` (with
and without the decode cache, which the port builds at 1x and doubles once
for the guided 2x batch), greedy `generate` ids and trajectories
(temperature 0, critic noise 0), `maskgit_loss` and its gradients with the
random draws fixed (`mask_override`, cond_drop_prob and self_cond_prob 0 or
1, the JAX gumbel monkeypatched to an argmax and zero gumbel noise on the
port's side), and the decay mask. Port-side: both critics together raise,
a train step moves every parameter group, and the generate and training
CLIs take each variant's overrides.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_tpu.training import optim as joptim
from bevgen_torch.core.config import MuseConfig
from bevgen_torch.core.convert import export_jax_params
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.models.stage2 import maskgit as tmg
from bevgen_torch.training import optim as toptim
from bevgen_torch.training import trainer as ttrainer
from torch_parity import (VARIANTS, assert_trees_close, tiny_pipelines,
                          variant_pipelines)

# fp32 on both sides, sums in another order: logits and scores 1e-4, loss
# values 1e-5, gradients 1e-5 of each leaf's largest entry
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
IMG_TOL = 1e-4
B = 2


def _inputs(tf, seed):
    """(ids with mask ids, ids of real tokens, cond, ii, ei) as numpy."""
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    shape = (B, tf.num_cams, tf.num_cam_tokens)
    ids = rng.integers(0, tf.vocab_size + 1, shape)
    real = rng.integers(0, tf.vocab_size, shape)
    cond = rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    return ids, real, cond, np.asarray(ii), np.asarray(ei)


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("variant", ["token_critic", "self_cond+token_critic",
                                     "self_cond"])
def test_variant_tree_shapes(variant):
    _, params, tp = variant_pipelines(variant)
    tf = tp.config.transformer
    tree = params["maskgit"]["params"]
    mg = tp.maskgit
    if tp.config.muse.token_critic:
        crit = tree["token_critic"]
        assert "critic" not in tree and not hasattr(mg, "critic")
        # no row for the mask id, a 1-wide head
        assert crit["token_emb"]["embedding"].shape[0] == tf.vocab_size
        assert crit["to_logits"]["kernel"].shape[-1] == 1
        assert tuple(mg.token_critic.token_emb.weight.shape) == (
            tf.vocab_size, tf.num_embed)
        assert tuple(mg.token_critic.to_logits.weight.shape) == (1, tf.num_embed)
        assert tuple(mg.transformer.token_emb.weight.shape) == (
            tf.vocab_size + 1, tf.num_embed)
    names = {n for n, _ in mg.named_parameters()}
    want = {f"{part}.self_cond_to_init_embed.{sub}"
            for part in (("transformer", "token_critic")
                         if tp.config.muse.token_critic else ("transformer",))
            for sub in ("norm_in.norm.weight", "proj_in.weight",
                        "norm_mid.norm.weight", "proj_out.weight")}
    assert (want <= names) == tf.self_cond
    assert tf.self_cond or not any("self_cond" in n for n in names)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cfg_logits_and_critic_match_jax(variant):
    jp, params, tp = variant_pipelines(variant)
    tf, muse = tp.config.transformer, tp.config.muse
    ids, real, cond, ii, ei = _inputs(tf, seed=1)
    sc = (np.random.default_rng(2).standard_normal(
        (B, tf.num_img_tokens, tf.num_embed)).astype(np.float32)
        if tf.self_cond else None)
    jargs = (_j(cond, jnp.int32), _j(ii), _j(ei))
    want_l, want_e, want_s = jax.jit(lambda p, x, r, c, i, e, s: (
        *jmg.cfg_logits(jp.maskgit, p, x, c, i, e, muse.cond_scale,
                        self_cond_embed=s, real_cfg=muse.real_cfg),
        jmg.cfg_critic(jp.maskgit, p, r, c, i, e, muse.cond_scale,
                       real_cfg=muse.real_cfg)))(
        params["maskgit"], _j(ids, jnp.int32), _j(real, jnp.int32), *jargs,
        None if sc is None else _j(sc))
    targs = (_t(cond), _t(ii), _t(ei))
    with torch.no_grad():
        caches = [(None, None), tmg.decode_caches(tp.maskgit, *targs)]
        for gen_cache, critic_cache in caches:
            got_l, got_e = tmg.cfg_logits(
                tp.maskgit, _t(ids), *targs, muse.cond_scale,
                self_cond_embed=None if sc is None else _t(sc),
                real_cfg=muse.real_cfg, cache=gen_cache)
            got_s = tmg.cfg_critic(tp.maskgit, _t(real), *targs,
                                   muse.cond_scale, real_cfg=muse.real_cfg,
                                   cache=critic_cache)
            what = f"{variant} cached={gen_cache is not None}"
            assert got_l.shape == want_l.shape and got_s.shape == real.shape
            assert got_e.shape == (B, tf.num_img_tokens, tf.num_embed)
            for name, got, want in (("logits", got_l, want_l),
                                    ("embed", got_e, want_e),
                                    ("scores", got_s, want_s)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=LOGIT_TOL, rtol=0,
                                           err_msg=f"{what} {name}")


def test_real_cfg_mixes_a_dropped_null_half():
    """Guidance at cond_scale 1 gives the cond pass; at another scale the
    null pass (condition dropped) enters, so the logits move."""
    _, _, tp = variant_pipelines("token_critic+real_cfg")
    tf = tp.config.transformer
    ids, real, cond, ii, ei = (_t(a) for a in _inputs(tf, seed=3))
    mg = tp.maskgit
    with torch.no_grad():
        plain, _ = tmg.cfg_logits(mg, ids, cond, ii, ei, 3.0)
        one, _ = tmg.cfg_logits(mg, ids, cond, ii, ei, 1.0, real_cfg=True)
        three, _ = tmg.cfg_logits(mg, ids, cond, ii, ei, 3.0, real_cfg=True)
        s_plain = tmg.cfg_critic(mg, real, cond, ii, ei, 3.0)
        s_three = tmg.cfg_critic(mg, real, cond, ii, ei, 3.0, real_cfg=True)
    np.testing.assert_allclose(one.numpy(), plain.numpy(), atol=LOGIT_TOL)
    assert np.abs(three.numpy() - plain.numpy()).max() > 1e-2
    assert np.abs(s_three.numpy() - s_plain.numpy()).max() > 1e-3


def _jax_generate(jp, params, cond, ii, ei, **kw):
    return jax.jit(lambda p, c, i, e: jmg.generate(
        jp.maskgit, p, c, i, e, jax.random.PRNGKey(0), **kw))(
        params["maskgit"], _j(cond, jnp.int32), _j(ii), _j(ei))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_matches_jax(variant):
    jp, params, tp = variant_pipelines(variant, greedy=True)
    tf, T = tp.config.transformer, tp.config.muse.sample_iterations
    _, _, cond, ii, ei = _inputs(tf, seed=5)
    want, want_traj = _jax_generate(jp, params, cond, ii, ei,
                                    return_trajectory=True)
    got, got_traj = tmg.generate(tp.maskgit, _t(cond), _t(ii), _t(ei),
                                 torch.Generator().manual_seed(0),
                                 return_trajectory=True)
    assert got.shape == (B, tf.num_cams) + tuple(tf.cam_latent_res)
    assert got_traj.shape == (T, B, tf.num_cams, tf.num_cam_tokens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_traj.numpy(), np.asarray(want_traj))
    np.testing.assert_array_equal(got_traj[-1].numpy(),
                                  got.reshape(got_traj[-1].shape).numpy())
    # the trajectory changes nothing else
    again = tmg.generate(tp.maskgit, _t(cond), _t(ii), _t(ei),
                         torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_with_fused_glue_matches_jax(variant):
    """Each variant with `transformer.use_fused_glue=True` on both sides
    (on the CPU the port's glue runs its plain twins): identical greedy
    ids and trajectories."""
    jp, params, tp = variant_pipelines(variant, greedy=True, glue=True)
    assert tp.config.transformer.use_fused_glue
    _, _, cond, ii, ei = _inputs(tp.config.transformer, seed=7)
    want, want_traj = _jax_generate(jp, params, cond, ii, ei,
                                    return_trajectory=True)
    got, got_traj = tmg.generate(tp.maskgit, _t(cond), _t(ii), _t(ei),
                                 torch.Generator().manual_seed(0),
                                 return_trajectory=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_traj.numpy(), np.asarray(want_traj))


def test_token_critic_generate_without_the_critic_matches_jax():
    jp, params, tp = variant_pipelines("token_critic", greedy=True)
    _, _, cond, ii, ei = _inputs(tp.config.transformer, seed=6)
    want = _jax_generate(jp, params, cond, ii, ei,
                         force_not_use_token_critic=True)
    got = tmg.generate(tp.maskgit, _t(cond), _t(ii), _t(ei),
                       force_not_use_token_critic=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_fn_trajectory_matches_jax():
    jp, params, tp = tiny_pipelines(greedy=True)
    batch = fake_batch(tp.config, B, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    want_img, want_ids, want_traj = jax.jit(
        lambda p, s, i, e: jp.generate_fn(p, s, i, e, jax.random.PRNGKey(0),
                                          return_trajectory=True))(
        params, _j(seg), _j(ii), _j(ei))
    got_img, got_ids, got_traj = tp.generate_fn(
        seg, ii, ei, torch.Generator().manual_seed(0), return_trajectory=True)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_traj.numpy(), np.asarray(want_traj))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


# ---- training ----------------------------------------------------------------

@pytest.fixture
def argmax_gumbel(monkeypatch):
    monkeypatch.setattr(jmg, "gumbel_sample",
                        lambda rng, logits, temp: jnp.argmax(logits, axis=-1))


def _models(variant, **muse_kw):
    """(jax MaskGit, its params {'params': ...}, port MaskGit) of a variant
    on the same weights, with `muse_kw` set on both."""
    jp, params, tp = variant_pipelines(variant)
    jmodel = jmg.MaskGit(jp.maskgit.cfg, dataclasses.replace(
        jp.maskgit.muse, **muse_kw), jnp.float32)
    tmodel = copy.deepcopy(tp.maskgit)
    tmodel.muse = dataclasses.replace(tmodel.muse, **muse_kw)
    return jmodel, params["maskgit"], tmodel


def _batch(tf, seed):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tf.vocab_size, (B, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    mask = rng.uniform(size=tokens.shape) < 0.5
    mask[..., 0] = True
    return tokens, cond, np.asarray(ii), np.asarray(ei), mask


@pytest.mark.parametrize("variant,cond_drop_prob,self_cond_prob", [
    ("token_critic", 1.0, 0.9), ("self_cond", 0.0, 0.0),
    ("self_cond+token_critic", 0.0, 1.0),
    ("self_cond+token_critic", 1.0, 1.0)])
def test_maskgit_loss_and_grads_match_jax(variant, cond_drop_prob,
                                          self_cond_prob, argmax_gumbel):
    jmodel, jparams, tmodel = _models(variant, cond_drop_prob=cond_drop_prob,
                                      self_cond_prob=self_cond_prob)
    tf = tmodel.cfg
    tokens, cond, ii, ei, mask = _batch(tf, seed=1)

    def f(p):
        out = jmg.maskgit_loss(jmodel, {"params": p}, jax.random.PRNGKey(0),
                               _j(tokens, jnp.int32), _j(cond, jnp.int32),
                               _j(ii), _j(ei), mask_override=_j(mask))
        return out.loss, out

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jparams["params"])
    out = tmg.maskgit_loss(
        tmodel, _t(tokens), _t(cond), _t(ii), _t(ei),
        generator=torch.Generator().manual_seed(0), mask_override=_t(mask),
        gumbel_noise=torch.zeros(tokens.shape + (tf.vocab_size,)))
    for name in ("loss", "ce_loss", "critic_loss"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(want, name)), atol=LOSS_TOL,
                                   rtol=0, err_msg=name)
    assert float(out.critic_loss.detach()) > 0
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad(out.loss, [p for p in tmodel.parameters()],
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, tmodel.parameters())]
    assert_trees_close(export_jax_params(tmodel, dict(zip(names, grads))),
                       jgrads, GRAD_RTOL, what="grad")
    # the self-conditioning feed-forward learns only when the pre-forward ran
    sc = [g for n, g in zip(names, grads)
          if n.startswith("transformer.self_cond_to_init_embed.")]
    assert not sc or bool(any(g.abs().max() > 0 for g in sc)) == (
        self_cond_prob == 1.0)


@pytest.mark.parametrize("variant", ["token_critic", "self_cond"])
def test_decay_mask_matches_jax(variant):
    _, jparams, tmodel = _models(variant)
    flags = toptim.decay_mask(tmodel)
    exported = export_jax_params(tmodel, {
        n: torch.full_like(p, float(flags[n]))
        for n, p in tmodel.named_parameters()})
    want = joptim.decay_mask(jparams["params"])
    got = jax.tree_util.tree_map(lambda a: bool(a.flat[0]), exported)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)


def test_train_step_moves_every_group():
    """One step of `make_train_step` with the TokenCritic and
    self-conditioning (the pre-forward always on) changes the generator,
    its self-conditioning feed-forward and the TokenCritic."""
    _, _, tmodel = _models("self_cond+token_critic", self_cond_prob=1.0,
                           cond_drop_prob=0.0)
    tf = tmodel.cfg
    tokens, cond, ii, ei, mask = _batch(tf, seed=2)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    state = ttrainer.create_train_state(tmodel, toptim.maskgit_optimizer(
        tmodel, 1e-3, warmup_steps=1))
    step = ttrainer.make_train_step()
    batch = {"tokens": _t(tokens), "cond_ids": _t(cond),
             "intrinsics_inv": _t(ii), "extrinsics_inv": _t(ei)}
    for _ in range(2):   # the first update has lr 0 (warm-up)
        m = step(state, batch, torch.Generator().manual_seed(0),
                 mask_override=_t(mask))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["critic_loss"]) > 0
    for prefix in ("transformer.layers_0_attn.", "transformer.to_logits.",
                   "transformer.self_cond_to_init_embed.proj_in.",
                   "token_critic.layers_1_ff.", "token_critic.to_logits."):
        moved = [n for n, p in tmodel.named_parameters()
                 if n.startswith(prefix) and not torch.equal(p, before[n])]
        assert moved, prefix


def test_both_critics_raise():
    from bevgen_torch.core.config import tiny_test_config
    tf = tiny_test_config().transformer
    with pytest.raises(ValueError, match="mutually exclusive"):
        tmg.MaskGit(tf, MuseConfig(self_token_critic=True, token_critic=True))


# ---- the CLIs ----------------------------------------------------------------

CLI_VARIANTS = {
    "real_cfg": ["muse.real_cfg=true"],
    "token_critic": ["muse.token_critic=true", "muse.self_token_critic=false"],
    "self_cond": ["transformer.self_cond=true"],
    "all": ["muse.real_cfg=true", "muse.token_critic=true",
            "muse.self_token_critic=false", "transformer.self_cond=true"],
}


@pytest.mark.parametrize("variant", list(CLI_VARIANTS))
def test_generate_cli_serves_variant(variant, tmp_path):
    from bevgen_torch.scripts import generate as cli
    pipe, paths = cli.run(["preset=tiny_test", "batch_size=2", "fake=1",
                           "seed=3", "device=cpu", f"out={tmp_path}",
                           "muse.sample_iterations=2", *CLI_VARIANTS[variant]])
    muse, tf = pipe.config.muse, pipe.config.transformer
    assert hasattr(pipe.maskgit, "token_critic") == muse.token_critic
    assert (variant in ("real_cfg", "all")) == muse.real_cfg
    assert (variant in ("self_cond", "all")) == tf.self_cond
    out = np.load(paths[0])
    assert out["ids"].shape == (2, 3, 4, 4)
    assert out["images"].shape == (2, 3, 32, 32, 3)
    assert np.isfinite(out["images"]).all()
    assert 0 <= out["ids"].min() and out["ids"].max() < tf.vocab_size


def test_train_cli_trains_variant(capsys):
    from bevgen_torch.scripts import train_stage2
    assert train_stage2.main(["preset=tiny_test", "device=cpu", "steps=2",
                              "batch_size=2", "log_every=1", "warmup_steps=1",
                              *CLI_VARIANTS["all"],
                              "muse.self_cond_prob=1.0"]) == 0
    import json
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(rows) == 2 and all(r["critic_loss"] > 0 for r in rows)
