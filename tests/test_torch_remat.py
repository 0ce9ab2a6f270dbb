"""`transformer.remat` in the PyTorch port against the JAX reference at
tiny_test, fp32 on the CPU: the port's `remat=True` loss and parameter
gradients against `jax.value_and_grad` of the JAX package's `remat=True`
`maskgit_loss` on one weight tree, in the plain and the fused-glue form;
remat on against remat off in the port, bit for bit; the checkpointed
regions (3 x num_layers per differentiated forward, none without
gradients) and the activations they stop holding; a greedy generate; the
override through `apply_overrides` and the train CLI.

The random draws are fixed as in tests/test_torch_training.py: the mask is
handed to both sides, cond_drop_prob is 0, the JAX `gumbel_sample` is
monkeypatched to an argmax and the port gets zero gumbel noise.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_torch.core.config import apply_overrides, tiny_test_config
from bevgen_torch.core.convert import export_jax_params
from bevgen_torch.models.stage2 import maskgit as tmg
from bevgen_torch.models.stage2 import transformer as ttr
from torch_parity import (assert_trees_close, tiny_pipelines,
                          variant_pipelines)

# fp32 on both sides, the bounds of tests/test_torch_training.py's parity
# tests: losses 1e-5 absolute (sums in another order), gradients 1e-5 of
# each leaf's largest entry (at least 1e-6 absolute)
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
B = 2
FORMS = ["plain", "glue"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch and BLAS in two threads for this module: beside the other test
    processes on the machine, more threads only contend for its cores."""
    from threadpoolctl import threadpool_limits
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(limits=2, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(old)


def _with_remat(model: tmg.MaskGit, remat: bool) -> tmg.MaskGit:
    """A copy of the port's `model` whose transformers are built with
    `remat`, on the same weights."""
    cfg = model.cfg.replace(remat=remat)
    other = tmg.MaskGit(cfg, model.muse, dtype=model.dtype)
    other.load_state_dict(model.state_dict())
    return other


@pytest.fixture(scope="module")
def built():
    """Per form: (JAX MaskGit with remat, its params {'params': ...}, the
    port's MaskGit with remat, the port's without), cond_drop_prob 0, on one
    weight tree."""
    out = {}
    for form in FORMS:
        jp, params, tp = tiny_pipelines(glue=form == "glue")
        muse = dataclasses.replace(jp.maskgit.muse, cond_drop_prob=0.0)
        jmodel = jmg.MaskGit(jp.maskgit.cfg.replace(remat=True), muse,
                             jnp.float32)
        off = copy.deepcopy(tp.maskgit)
        off.muse = dataclasses.replace(off.muse, cond_drop_prob=0.0)
        out[form] = (jmodel, params["maskgit"], _with_remat(off, True), off)
    return out


def _batch(tf, seed):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tf.vocab_size, (B, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens))
    ii, ei = (np.asarray(a) for a in canonical_rig_inverses(tf, B))
    mask = rng.uniform(size=tokens.shape) < 0.5
    mask[..., 0] = True
    return tokens, cond, ii, ei, mask


def _port_loss(model, batch, seed=0, fixed=True):
    tokens, cond, ii, ei, mask = batch
    return tmg.maskgit_loss(
        model, torch.from_numpy(tokens), torch.from_numpy(cond),
        torch.from_numpy(ii), torch.from_numpy(ei),
        generator=torch.Generator().manual_seed(seed),
        mask_override=torch.from_numpy(mask) if fixed else None,
        gumbel_noise=(torch.zeros(tokens.shape + (model.cfg.vocab_size,))
                      if fixed else None))


def _grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(
        loss, [p for _, p in model.named_parameters()])))


@pytest.fixture
def regions(monkeypatch):
    """Counts the transformer's checkpointed regions."""
    calls = []
    real = ttr.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(type(fn).__name__)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(ttr, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("form", FORMS)
def test_remat_loss_and_grads_match_jax(form, built, monkeypatch, regions):
    monkeypatch.setattr(jmg, "gumbel_sample",
                        lambda rng, logits, temp: jnp.argmax(logits, axis=-1))
    jmodel, jparams, tmodel, _ = built[form]
    batch = _batch(tmodel.cfg, seed=1)
    tokens, cond, ii, ei, mask = batch

    def f(p):
        out = jmg.maskgit_loss(jmodel, {"params": p}, jax.random.PRNGKey(0),
                               jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(cond, jnp.int32), jnp.asarray(ii),
                               jnp.asarray(ei), mask_override=jnp.asarray(mask))
        return out.loss, out

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jparams["params"])
    out = _port_loss(tmodel, batch)
    for name in ("loss", "ce_loss", "critic_loss"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(want, name)), atol=LOSS_TOL,
                                   rtol=0, err_msg=name)
    assert float(out.critic_loss.detach()) > 0
    grads = _grads(tmodel, out.loss)
    assert_trees_close(export_jax_params(tmodel, grads), jgrads, GRAD_RTOL,
                       what="grad")
    # the generator's and the self-critic's forwards, 3 regions per layer
    assert len(regions) == 2 * 3 * tmodel.cfg.num_layers


@pytest.mark.parametrize("variant", ["plain", "glue", "self_cond+token_critic"])
def test_remat_equals_no_remat_bit_for_bit(variant, built, regions):
    """The same loss and gradients to the bit, with the draws left to the
    generator (the mask, cond_keep, the gumbel resample; with self_cond the
    no-grad pre-forward at self_cond_prob 1, which runs no region)."""
    if variant in built:
        off = built[variant][3]
    else:
        off = copy.deepcopy(variant_pipelines(variant)[2].maskgit)
        off.muse = dataclasses.replace(off.muse, self_cond_prob=1.0)
    on = _with_remat(off, True)
    batch = _batch(off.cfg, seed=2)
    want = _port_loss(off, batch, seed=3, fixed=False)
    want_g = _grads(off, want.loss)
    assert regions == []
    got = _port_loss(on, batch, seed=3, fixed=False)
    got_g = _grads(on, got.loss)
    for name in ("loss", "ce_loss", "critic_loss"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got_g.keys() == want_g.keys()
    for name, g in want_g.items():
        assert torch.equal(got_g[name], g), name
    layers = off.cfg.num_layers
    assert len(regions) == 2 * 3 * layers
    assert regions[:3] == ["CosineAttention", "CosineAttention",
                           "GEGLUFeedForward"]


def test_remat_holds_fewer_activations(built):
    """What autograd saves outside the regions: with remat, each block's
    inputs in place of everything its forward saves."""
    _, _, on, off = built["plain"]
    batch = _batch(off.cfg, seed=4)
    saved = {}
    for name, model in (("off", off), ("on", on)):
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = _port_loss(model, batch).loss
        torch.autograd.grad(loss, list(model.parameters()))
        saved[name] = sum(nbytes)
    assert saved["on"] < 0.5 * saved["off"], saved


def test_generate_with_remat_gives_the_same_greedy_ids(regions):
    from bevgen_torch.data.fake import fake_batch
    _, _, tp = tiny_pipelines(greedy=True)
    on = copy.deepcopy(tp)
    on.maskgit = _with_remat(tp.maskgit, True)
    batch = fake_batch(tp.config, 2, seed=0)
    inputs = [batch[k] for k in ("segmentation", "intrinsics_inv",
                                 "extrinsics_inv")]
    ids = [pipe.generate_fn(*inputs, torch.Generator().manual_seed(0))[1]
           for pipe in (tp, on)]
    assert torch.equal(ids[0], ids[1])
    assert regions == []


def test_remat_override_reaches_the_config_and_the_train_cli(tmp_path,
                                                              capsys, regions):
    base = tiny_test_config()
    assert base.transformer.remat is False
    on = apply_overrides(base, {"transformer.remat": "true"})
    assert on.transformer.remat is True
    assert apply_overrides(on, {"transformer.remat": "false"}).transformer.remat \
        is False
    from bevgen_torch.scripts import train_stage2
    assert train_stage2.main([
        "preset=tiny_test", "device=cpu", "steps=1", "batch_size=2",
        "log_every=1", "transformer.remat=true",
        f"ckpt_dir={tmp_path}"]) == 0
    assert "done" in capsys.readouterr().out
    assert len(regions) == 2 * 3 * base.transformer.num_layers
