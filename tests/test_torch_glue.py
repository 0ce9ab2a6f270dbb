"""The fused-glue path of the PyTorch port against the JAX reference, fp32
(and bf16 where stated) on the CPU: the residual + LayerNorm, GEGLU +
LayerNorm and standalone LayerNorm ops (the plain twins of the CUDA
kernels) against the Pallas kernels in interpret mode and the reference's
plain versions, their autograd Functions against jax.grad, and the
`use_fused_glue=True` transformer, generate and train step against the
JAX MaskGit with the same switch, on one weight tree.

The GEGLU op takes the projection's unpadded (.., 2F) output where the TPU
kernel takes each half padded to a multiple of 128: the reference's side
gets the padded layout (zeros beyond F) and its output is sliced to F.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import fused_glue as jfg
from bevgen_tpu.ops.pallas import layernorm as jln
from bevgen_torch.core.convert import export_jax_params, load_jax_params
from bevgen_torch.ops import fused_glue as fg
from bevgen_torch.ops import layernorm as ln
from torch_parity import assert_trees_close, tiny_pipelines, tiny_tree

# fp32, the same formula on both sides (sums in another order)
OP_TOL = 1e-6
# the GEGLU's erf: exact here and in the reference's plain version, the
# Abramowitz-Stegun polynomial (error 1.5e-7) in the TPU kernel
GEGLU_TOL = 1e-5
# gradients: 1e-5 of each gradient's largest entry
GRAD_RTOL = 1e-5
# whole transformer, fp32: 14 matmul chains summed in another order (the
# bound of tests/test_torch_transformer.py); against the port's own
# no-glue form, the JAX test's bound (tests/test_fused_glue.py)
TF_TOL = 1e-4
GLUE_VS_PLAIN_TOL = 2e-4
IMG_TOL = 1e-4
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(rng, shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1024), (4, 2730)])
def test_residual_layernorm_matches_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x, d = _normal(rng, shape), _normal(rng, shape)
    g = _normal(rng, shape[-1:], 0.2, 1.0)
    jx, jd = (jnp.asarray(a, JAX_DT[dtype]) for a in (x, d))
    kx, kn = jfg.residual_layernorm_fwd(jx, jd, jnp.asarray(g), tile=8,
                                        interpret=True)
    rx, rn = jfg._res_ln_reference(jx, jd, jnp.asarray(g), JAX_DT[dtype])
    tx, td = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (x, d))
    with torch.no_grad():
        px, pn = fg.residual_layernorm(tx, td, torch.from_numpy(g))
    assert px.dtype == pn.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(_f32(px), _f32(kx))
    np.testing.assert_array_equal(_f32(px), _f32(rx))
    for want in (kn, rn):
        if dtype == "float32":
            np.testing.assert_allclose(_f32(pn), _f32(want), atol=OP_TOL, rtol=0)
        else:
            # both round the same fp32 value to bf16; a statistic summed in
            # another order may move a value across a rounding boundary:
            # then they part by one bf16 step (2^-7 relative at most)
            diff = np.abs(_f32(pn) - _f32(want))
            assert (diff <= 2.0 ** -7 * np.abs(_f32(want)) + 1e-6).all()
            assert (diff > 0).mean() <= 1e-2


def _padded(y, F):
    """The TPU wrapper's layout: each half of [a | gate] padded to a
    multiple of 128 with zeros."""
    fp = -(-F // 128) * 128
    pad = ((0, 0), (0, fp - F))
    return np.concatenate([np.pad(y[:, :F], pad), np.pad(y[:, F:], pad)], -1), fp


@pytest.mark.parametrize("F", [170, 2730])
def test_geglu_layernorm_unpadded_matches_jax_padded(F):
    rng = np.random.default_rng(F)
    rows = 6
    y = _normal(rng, (rows, 2 * F))
    g = _normal(rng, (F,), 0.2, 1.0)
    yp, fp = _padded(y, F)
    gp = np.pad(g, (0, fp - F))
    kern = jfg.geglu_layernorm_fwd(jnp.asarray(yp), jnp.asarray(gp), F, tile=8,
                                   interpret=True)
    ref = jfg._geglu_ln_reference(jnp.asarray(yp), jnp.asarray(gp), F,
                                  jnp.float32)
    with torch.no_grad():
        got = fg.geglu_layernorm(torch.from_numpy(y), torch.from_numpy(g))
    assert tuple(got.shape) == (rows, F)
    for want in (kern, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :F],
                                   atol=GEGLU_TOL, rtol=0)
    # over (b, n) leading dims the op is the same, row by row
    with torch.no_grad():
        again = fg.geglu_layernorm(torch.from_numpy(y).reshape(2, 3, 2 * F),
                                   torch.from_numpy(g))
    np.testing.assert_array_equal(again.reshape(rows, F).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(2, 9, 128), (1, 12, 170), (2, 16, 1024),
                                   (3, 8, 2730)])
def test_layernorm_matches_jax(shape):
    rng = np.random.default_rng(shape[-1])
    x = _normal(rng, shape, 3.0, 1.0)
    s = _normal(rng, shape[-1:], 0.1, 1.0)
    want = jln.fused_layernorm(jnp.asarray(x), jnp.asarray(s), interpret=True)
    dense = jln.make_layernorm(use_pallas=False)(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        got = ln.layernorm(torch.from_numpy(x), torch.from_numpy(s))
    # inputs of scale 3 about 1: 1e-5 on outputs up to about 5
    for ref in (want, dense):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def _grad_case(op, rng):
    """(port Function, its numpy inputs, the JAX function, output weights)."""
    if op == "residual":
        shape = (2, 7, 64)
        args = (_normal(rng, shape), _normal(rng, shape),
                _normal(rng, (64,), 0.2, 1.0))
        return (fg.ResidualLayerNormFn, args,
                jfg.make_residual_layernorm(use_pallas=False),
                [_normal(rng, shape), _normal(rng, shape)])
    if op == "geglu":
        F = 170
        args = (_normal(rng, (2, 5, 2 * F)), _normal(rng, (F,), 0.2, 1.0))
        return (fg.GegluLayerNormFn, args,
                jfg.make_geglu_layernorm(F, use_pallas=False),
                [_normal(rng, (2, 5, F))])
    args = (_normal(rng, (2, 9, 96), 2.0, 0.5), _normal(rng, (96,), 0.1, 1.0))
    return (ln.LayerNormFn, args, jln.make_layernorm(use_pallas=False),
            [_normal(rng, (2, 9, 96))])


@pytest.mark.parametrize("op", ["residual", "geglu", "layernorm"])
def test_function_gradients_match_jax(op):
    fn, args, jfn, weights = _grad_case(op, np.random.default_rng(7))

    def jloss(*a):
        outs = jfn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    outs = fn.apply(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(isinstance(o.grad_fn, fn._backward_cls) for o in outs)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())
    # only the inputs that need a gradient get one
    part = [torch.from_numpy(a).requires_grad_(i == 0) for i, a in enumerate(args)]
    outs = fn.apply(*part)
    outs = outs if isinstance(outs, tuple) else (outs,)
    (g0,) = torch.autograd.grad(sum(o.sum() for o in outs), part[:1])
    assert g0.shape == part[0].shape


def _tf_inputs(tf, seed, b=2):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, tf.vocab_size + 1, (b, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (b, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, b)
    return ids, cond, np.asarray(ii), np.asarray(ei)


@pytest.mark.parametrize("cached,keep", [(False, None), (True, None),
                                         (False, (True, False))])
def test_glue_transformer_matches_jax_and_the_plain_form(cached, keep):
    jp, params, tp = tiny_pipelines(glue=True)
    plain = tiny_pipelines()[2].maskgit
    assert tp.maskgit.transformer.use_glue and not plain.transformer.use_glue
    tf = tp.config.transformer
    ids, cond, ii, ei = _tf_inputs(tf, seed=11)
    jkeep = None if keep is None else jnp.asarray(keep)
    want = jp.maskgit.apply(params["maskgit"], jnp.asarray(ids, jnp.int32),
                            jnp.asarray(cond, jnp.int32), jnp.asarray(ii),
                            jnp.asarray(ei), cond_keep=jkeep)
    t = [torch.from_numpy(a) for a in (ids, cond, ii, ei)]
    tkeep = None if keep is None else torch.tensor(keep)
    with torch.no_grad():
        cache = tp.maskgit.build_cache(*t[1:]) if cached else None
        got = tp.maskgit(*t, cond_keep=tkeep, cache=cache)
        other = plain(*t, cond_keep=tkeep, cache=cache)
    for name in ("logits", "embed"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TF_TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(other, name).numpy(),
                                   atol=GLUE_VS_PLAIN_TOL, rtol=0, err_msg=name)


def test_load_jax_params_fills_every_parameter_from_the_glue_tree():
    tree = tiny_tree(glue=True)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(tiny_tree()))
    tp = tiny_pipelines(glue=True)[2]
    ff = tree["maskgit"]["params"]["transformer"]["layers_1_ff"]
    np.testing.assert_array_equal(
        tp.maskgit.transformer.layers_1_ff.proj_in.weight.detach().numpy(),
        ff["proj_in"]["kernel"].T)
    np.testing.assert_array_equal(
        tp.maskgit.transformer.layers_1_ff.norm_mid.norm.weight.detach().numpy(),
        ff["norm_mid"]["norm"]["scale"])
    out = export_jax_params(tp)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(out),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the loader consumes the glue tree into a fresh pipeline, every leaf
    fresh = copy.deepcopy(tp)
    for p in fresh.parameters():
        p.data.zero_()
    load_jax_params(fresh, tree)
    for (n, a), b in zip(fresh.named_parameters(), tp.parameters()):
        assert torch.equal(a, b), n


def test_greedy_generate_with_glue_matches_jax():
    from bevgen_torch.data.fake import fake_batch
    jp, params, tp = tiny_pipelines(greedy=True, glue=True)
    batch = fake_batch(tp.config, 2, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    want_img, want_ids = jax.jit(jp.generate_fn)(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei),
        jax.random.PRNGKey(0))
    got_img, got_ids = tp.generate_fn(seg, ii, ei,
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


def test_train_step_with_glue_matches_jax(monkeypatch):
    """One port make_train_step with glue on: its gradients against
    jax.grad of the reference's maskgit_loss with glue on, and its metrics
    against the reference's make_train_step, under the same fixed mask
    (the random draws are fixed as in tests/test_torch_training.py)."""
    from functools import partial
    from bevgen_tpu.models.stage2 import maskgit as jmg
    from bevgen_tpu.training import optim as joptim
    from bevgen_tpu.training import trainer as jtrainer
    from bevgen_torch.training import optim as toptim
    from bevgen_torch.training import trainer as ttrainer
    monkeypatch.setattr(jmg, "gumbel_sample",
                        lambda rng, logits, temp: jnp.argmax(logits, axis=-1))
    jp, params, tp = tiny_pipelines(glue=True)
    muse = dataclasses.replace(jp.maskgit.muse, cond_drop_prob=0.0)
    jmodel = jmg.MaskGit(jp.maskgit.cfg, muse, jnp.float32)
    tmodel = copy.deepcopy(tp.maskgit)
    tmodel.muse = dataclasses.replace(tmodel.muse, cond_drop_prob=0.0)
    tf = tp.config.transformer
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, tf.vocab_size, (2, tf.num_cams, tf.num_cam_tokens))
    _, cond, ii, ei = _tf_inputs(tf, seed=13)
    mask = rng.uniform(size=tokens.shape) < 0.5
    mask[..., 0] = True
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "cond_ids": jnp.asarray(cond, jnp.int32),
          "intrinsics_inv": jnp.asarray(ii), "extrinsics_inv": jnp.asarray(ei)}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in
          (("tokens", tokens), ("cond_ids", cond), ("intrinsics_inv", ii),
           ("extrinsics_inv", ei))}

    def jloss(p):
        return jmg.maskgit_loss(jmodel, {"params": p}, jax.random.PRNGKey(0),
                                jb["tokens"], jb["cond_ids"],
                                jb["intrinsics_inv"], jb["extrinsics_inv"],
                                mask_override=jnp.asarray(mask)).loss

    jgrads = jax.grad(jloss)(params["maskgit"]["params"])
    monkeypatch.setattr(jtrainer, "maskgit_loss",
                        partial(jmg.maskgit_loss, mask_override=jnp.asarray(mask)))
    tx = joptim.maskgit_optimizer(1e-3, warmup_steps=1, total_steps=10,
                                  params_example=params["maskgit"]["params"])
    jstate = jtrainer.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params["maskgit"]), tx)
    _, jm = jax.jit(jtrainer.make_train_step(jmodel, tx, ema_decay=0.9))(
        jstate, jb, jax.random.PRNGKey(0))

    opt = toptim.maskgit_optimizer(tmodel, 1e-3, warmup_steps=1, total_steps=10)
    seen = {}
    step_fn = opt.step
    monkeypatch.setattr(opt, "step", lambda grads: seen.setdefault(
        "grads", list(grads)) and step_fn(grads))
    state = ttrainer.create_train_state(tmodel, opt)
    m = ttrainer.make_train_step(ema_decay=0.9)(
        state, tb, torch.Generator().manual_seed(0),
        mask_override=torch.from_numpy(mask),
        gumbel_noise=torch.zeros(tokens.shape + (tf.vocab_size,)))
    for key in ("loss", "ce_loss", "critic_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-5,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    name = {id(p): n for n, p in tmodel.named_parameters()}
    grads = {name[id(p)]: g for p, g in zip(opt.params, seen["grads"])}
    assert len(grads) == len(name)
    assert_trees_close(export_jax_params(tmodel, grads), jgrads, GRAD_RTOL,
                       what="grad")


@pytest.mark.parametrize("shape,fused", [((2, 9, 64), True), ((12, 64), True),
                                         ((2, 5, 64), False), ((64,), False)])
def test_layernorm_g_use_fused_matches_jax(monkeypatch, shape, fused):
    """LayerNormG(use_fused=True) takes the standalone op only for inputs of
    at least 8 rows (the reference's rule), and agrees with the JAX module
    on both sides of it."""
    from bevgen_tpu.models.stage2.transformer import LayerNormG as JaxLayerNormG
    from bevgen_torch.models.stage2 import transformer as ttr
    calls = []
    monkeypatch.setattr(ttr, "layernorm",
                        lambda *a: calls.append(1) or ln.layernorm(*a))
    rng = np.random.default_rng(3)
    x = _normal(rng, shape, 2.0, 0.5)
    g = _normal(rng, (64,), 0.1, 1.0)
    want = JaxLayerNormG(use_fused=True).apply(
        {"params": {"norm": {"scale": jnp.asarray(g)}}}, jnp.asarray(x))
    mod = ttr.LayerNormG(64, use_fused=True)
    with torch.no_grad():
        mod.norm.weight.copy_(torch.from_numpy(g))
        got = mod(torch.from_numpy(x), torch.float32)
    assert calls == ([1] if fused else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_overrides_turn_the_glue_on_through_the_entry_points():
    """`transformer.use_fused_glue=true` from the command line reaches the
    transformer (the Optional[bool] field is coerced by its annotation)."""
    from bevgen_torch.core.config import apply_overrides, tiny_test_config
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    base = tiny_test_config()
    assert base.transformer.use_fused_glue is None
    on = apply_overrides(base, {"transformer.use_fused_glue": "true"})
    assert on.transformer.use_fused_glue is True
    off = apply_overrides(on, {"transformer.use_fused_glue": "false"})
    assert off.transformer.use_fused_glue is False
    for cfg, glue in ((base, False), (on, True), (off, False)):
        tfm = BEVGenPipeline.create(cfg, device="cpu").maskgit.transformer
        assert tfm.use_glue is glue
        assert all(tfm.layer(i)[2].use_glue is glue
                   for i in range(cfg.transformer.num_layers))
