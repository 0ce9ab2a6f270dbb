"""Stage-1 training in the PyTorch port against the JAX package, fp32 on
the CPU: the training quantizer and its two variants, the VQ models'
encode loss and forward, the PatchGAN discriminator (BatchNorm and
ActNorm) and `convert_discriminator`, every stage-1 loss with its log keys,
and two steps each of the VQ-GAN (disc_start 0 with an LPIPS term at full
VGG widths, disc_start 1 without), segmentation and no-discriminator
trainers. Weights are one numpy tree (`torch_parity.random_tree`) loaded
into both packages; the JAX test's `small_cfg` (tests/test_training.py)
with ndf 8 and 2 discriminator layers.

Tolerances: the quantizers and losses 1e-6 (the same fp32 arithmetic in
another order); model outputs 1e-5 (fp32 convolutions summed in another
order); loss gradients rtol 1e-4 of each leaf's largest entry; train-step
metrics rtol 1e-4, parameters after two Adam steps
`torch_parity.assert_steps_close`. Some leaves have no gradient in exact
arithmetic: the attention `k` biases (softmax is shift-invariant) and, at
this width (16 channels in 16 groups), every bias that feeds a GroupNorm
through the residual stream. Adam scales their rounding noise to steps of
up to ~lr, so after the gradient test has held them to zero on both sides,
the step test bounds their change by Adam's largest two steps instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bevgen_tpu.core import checkpoint as jckpt
from bevgen_tpu.core.config import Stage1Config as JaxStage1Config
from bevgen_tpu.models.discriminator import NLayerDiscriminator as JaxDisc
from bevgen_tpu.models.lpips import LPIPS as JaxLPIPS
from bevgen_tpu.models.stage1 import quantize as jq
from bevgen_tpu.models.stage1.vq import VQModel as JaxVQ
from bevgen_tpu.models.stage1.vq import VQSegmentationModel as JaxSegVQ
from bevgen_tpu.training import losses as jl
from bevgen_tpu.training import optim as joptim
from bevgen_tpu.training import stage1_trainer as jtrain
from bevgen_torch.core import checkpoint as tckpt
from bevgen_torch.core.config import Stage1Config
from bevgen_torch.core.convert import export_jax_params, load_jax_params
from bevgen_torch.models.discriminator import NLayerDiscriminator
from bevgen_torch.models.lpips import LPIPS
from bevgen_torch.models.stage1 import quantize as tq
from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
from bevgen_torch.training import losses as tl
from bevgen_torch.training import stage1_trainer as ttrain
from torch_parity import assert_steps_close, assert_trees_close, random_tree

LR = 1e-3
SMALL = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             resolution=16, z_channels=16, n_embed=16, embed_dim=8)
SEG = dict(in_channels=7, out_ch=7, n_labels=7)
DISC = dict(ndf=8, n_layers=2)


def small_cfgs(**kw):
    """(JAX, port) Stage1Config of tests/test_training.py:small_cfg."""
    return JaxStage1Config(**SMALL, **kw), Stage1Config(**SMALL, **kw)


def images(seed, b=2, c=3, labels=False):
    rng = np.random.default_rng(seed)
    if labels:
        return (rng.uniform(size=(b, 16, 16, c)) < 0.3).astype(np.float32)
    return rng.standard_normal((b, 16, 16, c)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=tol, rtol=tol,
        err_msg=what)


# ---- the numpy weight trees ----------------------------------------------


@pytest.fixture(scope="module")
def trees():
    """{"cam", "bev", "disc", "disc_actnorm", "lpips"}: numpy trees in the
    JAX layouts ({"params": ...}), from seeds."""
    out = {}
    for name, kw, seed in (("cam", {}, 0), ("bev", SEG, 1)):
        jc, _ = small_cfgs(**kw)
        cls = JaxSegVQ if kw else JaxVQ
        x = jnp.zeros((2, 16, 16, jc.in_channels))
        out[name] = random_tree(jax.eval_shape(
            cls(jc).init, jax.random.PRNGKey(0), x), seed)
    x = jnp.zeros((2, 16, 16, 3))
    for name, act, seed in (("disc", False, 2), ("disc_actnorm", True, 3)):
        out[name] = random_tree(jax.eval_shape(
            JaxDisc(**DISC, use_actnorm=act).init, jax.random.PRNGKey(0), x),
            seed)
    out["lpips"] = random_tree(jax.eval_shape(
        JaxLPIPS().init, jax.random.PRNGKey(0), x, x), 4)
    return out


def jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_vq(tree, seg=False):
    _, tc = small_cfgs(**(SEG if seg else {}))
    return load_jax_params((VQSegmentationModel if seg else VQModel)(tc), tree)


def port_disc(tree, actnorm=False):
    return load_jax_params(NLayerDiscriminator(**DISC, use_actnorm=actnorm),
                           tree)


# ---- the quantizers --------------------------------------------------------


def _z_codebook(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 4, 8)).astype(np.float32),
            (0.5 * rng.standard_normal((16, 8))).astype(np.float32))


@pytest.mark.parametrize("legacy", [True, False])
def test_quantize_loss_and_straight_through_gradient(legacy):
    z, cb = _z_codebook(0)
    w = np.random.default_rng(1).standard_normal(z.shape).astype(np.float32)

    def jf(z_, cb_):
        r = jq.quantize(z_, cb_, 0.25, legacy)
        return jnp.sum(r.z_q * w) + r.loss, r

    (_, jr), (jgz, jgc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(cb))
    tz, tcb = t(z).requires_grad_(), t(cb).requires_grad_()
    r = tq.quantize(tz, tcb, 0.25, legacy)
    tgz, tgc = torch.autograd.grad((r.z_q * t(w)).sum() + r.loss, (tz, tcb))
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    close(r.z_q, jr.z_q, 1e-6, "z_q")
    close(r.loss, jr.loss, 1e-6, "loss")
    close(tgz, jgz, 1e-6, "dz (straight-through)")
    close(tgc, jgc, 1e-6, "dcodebook")


def test_codebook_stats():
    idx = np.random.default_rng(2).integers(0, 12, (2, 4, 4))
    want = jq.codebook_stats(jnp.asarray(idx), 16)
    got = tq.codebook_stats(torch.from_numpy(idx), 16)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], 1e-6, k)


@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_quantize_without_noise(hard):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    cb = rng.standard_normal((16, 8)).astype(np.float32)
    w = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)

    def jf(lg):
        r = jq.gumbel_quantize(lg, jnp.asarray(cb), None, 0.7, hard)
        return jnp.sum(r.z_q * w) + r.loss, r

    (_, jr), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    tlg = t(logits).requires_grad_()
    r = tq.gumbel_quantize(tlg, t(cb), None, 0.7, hard)
    tg, = torch.autograd.grad((r.z_q * t(w)).sum() + r.loss, tlg)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    close(r.z_q, jr.z_q, 1e-6, "z_q")
    close(r.loss, jr.loss, 1e-6, "kl")
    close(tg, jg, 1e-6, "dlogits")


def test_gumbel_quantize_noise_comes_from_the_generator():
    rng = np.random.default_rng(4)
    logits, cb = t(rng.standard_normal((2, 4, 4, 16))), t(
        rng.standard_normal((16, 8)))
    draws = [tq.gumbel_quantize(logits, cb, torch.Generator().manual_seed(s))
             for s in (5, 5, 6)]
    assert torch.equal(draws[0].z_q, draws[1].z_q)
    assert not torch.equal(draws[0].indices, draws[2].indices)
    assert torch.isfinite(draws[2].z_q).all()


@pytest.mark.parametrize("update", [True, False])
def test_ema_quantize(update):
    z, cb = _z_codebook(5)
    rng = np.random.default_rng(6)
    cluster = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    avg = (cb * cluster[:, None]).astype(np.float32)
    jr, jnew = jq.ema_quantize(*(jnp.asarray(a) for a in (z, cb, cluster, avg)),
                               update=update)
    tr, tnew = tq.ema_quantize(t(z), t(cb), t(cluster), t(avg), update=update)
    np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
    close(tr.z_q, jr.z_q, 1e-6, "z_q")
    close(tr.loss, jr.loss, 1e-6, "loss")
    for name, g, w in zip(("codebook", "cluster_size", "embed_avg"), tnew, jnew):
        close(g, w, 1e-6, name)


# ---- the models ---------------------------------------------------------------


@pytest.mark.parametrize("which", ["cam", "bev"])
def test_encode_loss_and_forward_match(trees, which):
    seg = which == "bev"
    jc, _ = small_cfgs(**(SEG if seg else {}))
    jm = (JaxSegVQ if seg else JaxVQ)(jc)
    params = jax_params(trees[which])
    x = images(7, c=jc.in_channels, labels=seg)
    je = jm.apply(params, jnp.asarray(x), method=JaxVQ.encode)
    jrec, jloss, jidx = jm.apply(params, jnp.asarray(x))
    tm = port_vq(trees[which], seg)
    with torch.no_grad():
        te = tm.encode(t(x))
        trec, tloss, tidx = tm(t(x))
    np.testing.assert_array_equal(te.indices.numpy(), np.asarray(je.indices))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(te.loss, je.loss, 1e-5, "encode loss")
    close(te.z_q, je.z_q, 1e-5, "z_q")
    close(tloss, jloss, 1e-5, "forward loss")
    close(trec, jrec, 1e-5, "reconstruction")
    if seg:
        want = jm.apply(params, jrec, method=JaxSegVQ.reconstruct_labels)
        np.testing.assert_array_equal(tm.reconstruct_labels(trec).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("actnorm", [False, True])
def test_discriminator_matches(trees, actnorm):
    tree = trees["disc_actnorm" if actnorm else "disc"]
    x = images(8)
    want = JaxDisc(**DISC, use_actnorm=actnorm).apply(jax_params(tree),
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = port_disc(tree, actnorm)(t(x))
    assert got.shape == want.shape == (2, 2, 2, 1)
    close(got, want, 1e-5)


def test_seeded_discriminator_has_unit_norm_scales():
    from bevgen_torch.models.init import init_weights
    for actnorm in (False, True):
        disc = init_weights(NLayerDiscriminator(use_actnorm=actnorm), 0)
        for n in (1, 2, 3):
            norm = getattr(disc, f"norm_{n}")
            scale = norm.scale if actnorm else norm.weight
            shift = norm.loc if actnorm else norm.bias
            assert torch.equal(scale, torch.ones_like(scale))
            assert torch.equal(shift, torch.zeros_like(shift))
        assert (disc.conv_1.bias is not None) == actnorm
        assert disc.conv_0.weight.std() > 0


def _reference_disc_state(actnorm, ndf=8, n_layers=3, seed=9):
    """A synthetic state dict in the reference's `main.` Sequential layout
    (conv at 0, conv/norm at 3n-1/3n, output conv at 3 (n_layers+1) - 1),
    with the running statistics, ActNorm's `initialized` and one stray
    key."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"main.0.weight": arr(ndf, 3, 4, 4), "main.0.bias": arr(ndf)}
    c = ndf
    for n in range(1, n_layers + 1):
        cout = ndf * min(2 ** n, 8)
        sd[f"main.{3 * n - 1}.weight"] = arr(cout, c, 4, 4)
        if actnorm:
            sd[f"main.{3 * n - 1}.bias"] = arr(cout)
            sd[f"main.{3 * n}.loc"] = arr(1, cout, 1, 1)
            sd[f"main.{3 * n}.scale"] = arr(1, cout, 1, 1)
            sd[f"main.{3 * n}.initialized"] = np.ones((), np.uint8)
        else:
            sd[f"main.{3 * n}.weight"] = arr(cout)
            sd[f"main.{3 * n}.bias"] = arr(cout)
            sd[f"main.{3 * n}.running_mean"] = arr(cout)
            sd[f"main.{3 * n}.running_var"] = arr(cout)
            sd[f"main.{3 * n}.num_batches_tracked"] = np.zeros((), np.int64)
        c = cout
    k = 3 * (n_layers + 1) - 1
    sd[f"main.{k}.weight"] = arr(1, c, 4, 4)
    sd[f"main.{k}.bias"] = arr(1)
    sd["head.extra"] = arr(2)
    return sd


@pytest.mark.parametrize("actnorm", [False, True])
def test_convert_discriminator_matches_jax(actnorm, capsys):
    sd = _reference_disc_state(actnorm)
    want = jckpt.convert_discriminator(sd)
    want_out = capsys.readouterr().out
    got = tckpt.convert_discriminator(sd)
    assert capsys.readouterr().out == want_out != ""
    flat = lambda tr: dict(jax.tree_util.tree_leaves_with_path(tr))
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_array_equal(g[path], w[path],
                                      err_msg=jax.tree_util.keystr(path))
    # the tree fills the port's discriminator, every parameter
    disc = load_jax_params(NLayerDiscriminator(ndf=8, use_actnorm=actnorm), got)
    np.testing.assert_array_equal(disc.conv_out.weight.detach().numpy(),
                                  sd["main.11.weight"])


# ---- the losses ------------------------------------------------------------------


def _logs_close(got, want, tol=1e-6):
    assert got.loss.shape == () and got.log.keys() == want.log.keys()
    close(got.loss, want.loss, tol, "loss")
    for k in want.log:
        close(got.log[k], want.log[k], tol, k)


def test_elementwise_losses_match():
    rng = np.random.default_rng(10)
    a, b = (rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
            for _ in range(2))
    close(tl.l1(t(a), t(b)), jl.l1(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    for fn in ("hinge_d_loss", "vanilla_d_loss"):
        close(getattr(tl, fn)(t(a), t(b)),
              getattr(jl, fn)(jnp.asarray(a), jnp.asarray(b)), 1e-6, fn)
    for step, start in ((0, 0), (3, 5), (5, 5)):
        close(tl.adopt_weight(0.7, step, start),
              jl.adopt_weight(0.7, step, start), 1e-6, f"adopt {step}/{start}")
    for n_nll, n_g in ((2.0, 0.5), (3.0, 1e-12), (0.0, 1.0)):
        close(tl.adaptive_disc_weight(torch.tensor(n_nll), torch.tensor(n_g)),
              jl.adaptive_disc_weight(jnp.float32(n_nll), jnp.float32(n_g)),
              1e-6, f"adaptive weight {n_nll}/{n_g}")


def test_dummy_and_bce_losses_match():
    x, xrec = images(11), images(12)
    q = np.float32(0.3)
    _logs_close(tl.dummy_loss(torch.tensor(q), t(x), t(xrec)),
                jl.dummy_loss(jnp.float32(q), jnp.asarray(x), jnp.asarray(xrec)))
    lab = images(13, c=7, labels=True)
    logits = 6 * images(14, c=7)
    _logs_close(tl.bce_seg_loss(torch.tensor(q), t(lab), t(logits), 0.5),
                jl.bce_seg_loss(jnp.float32(q), jnp.asarray(lab),
                                jnp.asarray(logits), 0.5))


@pytest.mark.parametrize("step,perceptual_weight", [(0, 1.0), (2, 0.0), (5, 0.5)])
def test_vqgan_losses_match(trees, step, perceptual_weight):
    x, xrec = images(15), images(16)
    q, dw = np.float32(0.2), np.float32(0.8)
    logits_fake = images(17, c=1)[:, :3, :3]
    perceptual = np.array([0.3, 0.6], np.float32)
    kw = dict(disc_start=3, perceptual_weight=perceptual_weight,
              codebook_weight=0.7)
    _logs_close(
        tl.vqgan_generator_loss(torch.tensor(q), t(x), t(xrec), t(logits_fake),
                                t(perceptual), step, disc_weight=torch.tensor(dw),
                                **kw),
        jl.vqgan_generator_loss(jnp.float32(q), jnp.asarray(x),
                                jnp.asarray(xrec), jnp.asarray(logits_fake),
                                jnp.asarray(perceptual), step,
                                disc_weight=jnp.float32(dw), **kw))
    jd = JaxDisc(**DISC)
    params = jax_params(trees["disc"])
    want = jl.vqgan_discriminator_loss(
        jnp.asarray(x), jnp.asarray(xrec), lambda p, y: jd.apply(p, y), params,
        step, disc_start=3)
    with torch.no_grad():
        got = tl.vqgan_discriminator_loss(t(x), t(xrec),
                                          port_disc(trees["disc"]), step,
                                          disc_start=3)
    _logs_close(got, want, 1e-5)


# ---- gradients and two train steps against the JAX package -----------------------


def _jax_loss(which):
    seg = which == "bev"
    jc, _ = small_cfgs(**(SEG if seg else {}))
    jm = (JaxSegVQ if seg else JaxVQ)(jc)
    x = jnp.asarray(images(30, c=jc.in_channels, labels=seg))

    def loss(p):
        rec, q, _ = jm.apply({"params": p}, x)
        return (jl.bce_seg_loss(q, x, rec) if seg
                else jl.dummy_loss(q, x, rec)).loss
    return loss, x


@pytest.fixture(scope="module")
def jax_grads(trees):
    """The JAX gradients of the dummy (cam) and BCE (bev) losses at the
    trees' weights."""
    return {w: jax.jit(jax.grad(_jax_loss(w)[0]))(
        jax_params(trees[w])["params"]) for w in ("cam", "bev")}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def zero_grad_leaves(grads):
    """The leaves whose gradient is zero up to rounding (1e-6 of the
    largest entry)."""
    flat = _flat(grads)
    top = max(np.abs(g).max() for g in flat.values())
    return {k for k, g in flat.items() if np.abs(g).max() <= 1e-6 * top}


@pytest.mark.parametrize("which", ["cam", "bev"])
def test_loss_gradients_match_jax(trees, jax_grads, which):
    seg = which == "bev"
    tm = port_vq(trees[which], seg)
    x = t(np.asarray(_jax_loss(which)[1]))
    rec, q, _ = tm(x)
    loss = (tl.bce_seg_loss(q, x, rec) if seg else tl.dummy_loss(q, x, rec)).loss
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    got = export_jax_params(tm, dict(zip(names, grads)))
    assert_trees_close(got, jax_grads[which], rtol=1e-4, what=which)
    zero = zero_grad_leaves(jax_grads[which])
    assert any("['k']['bias']" in k for k in zero) and len(zero) < len(
        _flat(got)) / 2


def assert_updates_close(tm, jparams, initial, zero, lr, what):
    """`assert_steps_close` on the leaves with a gradient; the others moved
    by at most Adam's two largest steps (about 1.04 lr each at betas
    (0.5, 0.9)) on both sides."""
    got, want = _flat(export_jax_params(tm)), _flat(jparams)
    assert got.keys() == want.keys()
    assert_steps_close({k: v for k, v in got.items() if k not in zero},
                       {k: v for k, v in want.items() if k not in zero}, lr,
                       what)
    for k in zero:
        for side, v in (("port", got[k]), ("jax", want[k])):
            assert np.abs(v - initial[k]).max() <= 2.1 * lr, \
                f"{what} {side} {k}"


def _jax_state(ae_tree, disc_tree, tx_ae, tx_disc):
    p_ae = jax_params(ae_tree)["params"]
    p_d = None if disc_tree is None else jax_params(disc_tree)["params"]
    return jtrain.Stage1TrainState(
        step=jnp.zeros((), jnp.int32), params_ae={"params": p_ae},
        params_disc=None if p_d is None else {"params": p_d},
        opt_ae=tx_ae.init(p_ae),
        opt_disc=None if p_d is None else tx_disc.init(p_d))


def _jax_nodisc_step(model, tx_ae):
    """The JAX CLI's no-discriminator step (scripts/train_stage1.py:146-163),
    which lives inside its main()."""

    def loss_fn(p, x):
        xrec, qloss, _ = model.apply({"params": p}, x)
        out = jl.dummy_loss(qloss, x, xrec)
        return out.loss, out.log

    def step(state, x, rng):
        (loss, log), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params_ae["params"], x)
        upd, opt_ae = tx_ae.update(grads, state.opt_ae,
                                   state.params_ae["params"])
        new = optax.apply_updates(state.params_ae["params"], upd)
        return state._replace(step=state.step + 1, params_ae={"params": new},
                              opt_ae=opt_ae), {**log, "loss": loss}
    return step


CASES = ["gan_start0_lpips", "gan_start1", "seg", "nodisc"]


@pytest.mark.parametrize("case", CASES)
def test_train_steps_match_jax(trees, jax_grads, case):
    seg = case == "seg"
    gan = case.startswith("gan")
    jc, _ = small_cfgs(**(SEG if seg else {}))
    jm = (JaxSegVQ if seg else JaxVQ)(jc)
    tx_ae, tx_disc = joptim.vqgan_optimizer(LR), joptim.vqgan_optimizer(LR)
    xs = [images(20 + i, c=jc.in_channels, labels=seg) for i in range(2)]

    tm = port_vq(trees["bev" if seg else "cam"], seg)
    initial = _flat(export_jax_params(tm))
    disc = port_disc(trees["disc"]) if gan else None
    state = ttrain.create_stage1_state(tm, disc, LR)
    if gan:
        disc_start = 1 if case == "gan_start1" else 0
        lpips_fn, jlpips = None, None
        if case.endswith("lpips"):
            lp = load_jax_params(LPIPS(), trees["lpips"]).requires_grad_(False)
            lpips_fn = lp
            jp = jax_params(trees["lpips"])
            jlpips = lambda a, b: JaxLPIPS().apply(jp, a, b)
        jd = JaxDisc(**DISC)
        jstep = jtrain.make_vqgan_train_step(jm, jd, tx_ae, tx_disc,
                                             lpips_fn=jlpips,
                                             disc_start=disc_start)
        tstep = ttrain.make_vqgan_train_step(lpips_fn, disc_start=disc_start)
        jstate = _jax_state(trees["cam"], trees["disc"], tx_ae, tx_disc)
    else:
        jstep = (jtrain.make_seg_train_step(jm, tx_ae) if seg
                 else _jax_nodisc_step(jm, tx_ae))
        tstep = (ttrain.make_seg_train_step() if seg
                 else ttrain.make_nodisc_train_step())
        jstate = _jax_state(trees["bev" if seg else "cam"], None, tx_ae, None)
    jstep = jax.jit(jstep)

    for i, x in enumerate(xs):
        jstate, jm_ = jstep(jstate, jnp.asarray(x), None)
        tm_ = tstep(state, t(x))
        assert tm_.keys() == jm_.keys(), case
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{case} step {i} {k}")
    assert state.step == int(jstate.step) == 2
    assert all(p.grad is None for p in tm.parameters())
    assert_updates_close(tm, jstate.params_ae["params"], initial,
                         zero_grad_leaves(jax_grads["bev" if seg else "cam"]),
                         LR, f"{case} autoencoder")
    if gan:
        assert all(p.grad is None for p in disc.parameters())
        assert_steps_close(export_jax_params(disc),
                           jstate.params_disc["params"], LR,
                           f"{case} discriminator")
        if case == "gan_start1":
            assert float(jm_["train/d_weight"]) >= 0
