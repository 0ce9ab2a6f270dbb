"""AR sparse-GPT training in the PyTorch port against the JAX reference,
fp32 on the CPU: the plain block-sparse backward against the TPU kernel
`block_sparse_attention_bwd` in interpret mode, the transposed tile plan,
`BlockSparseAttentionFn` (its kernel launches replaced by the plain
versions) against autograd, `bbox_token_weights`, `ar_loss` and its
gradients, one `make_ar_train_step` against `make_ar_sharded_train_step`
on a dp=1 mesh, the decay mask over the GPT tree, and the GPT's dropout.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import ar as jar
from bevgen_tpu.ops.pallas.block_sparse import (block_sparse_attention,
                                                block_sparse_attention_bwd)
from bevgen_tpu.parallel import sharding as shd
from bevgen_tpu.training import optim as joptim
from bevgen_tpu.training import trainer as jtrainer
from bevgen_torch.core.convert import export_jax_params
from bevgen_torch.models import masks as tmasks
from bevgen_torch.models.stage2 import ar as tar
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.ops import block_sparse as bs
from bevgen_torch.training import optim as toptim
from bevgen_torch.training import trainer as ttrainer
from torch_parity import (NUSCENES_GPT, ar_tiny_configs, ar_tiny_pipelines,
                          assert_steps_close, assert_trees_close, gpt_inputs,
                          gpt_pair)

# fp32 attention gradients: the same dense arithmetic in another order, held
# to 1e-5 of each gradient's largest entry
BWD_RTOL = 1e-5
# loss values 1e-5 absolute; parameter gradients 1e-5 of each leaf's largest
# entry (at least 1e-6 absolute): the same chain of fp32 products
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5

# L, block, nc, num_pad, JAX tile: aligned and unaligned, with and without
# pad rows, blocks 8 and 16, the TPU kernel's tile 64 and 128
BWD_CASES = {
    "b8-t64": (128, 8, 16, 0, 64),
    "b16-t64-unaligned-pad": (100, 16, 20, 6, 64),
    "b8-t128-unaligned-pad": (200, 8, 24, 8, 128),
    "b16-t128-pad": (128, 16, 32, 5, 128),
}


def _sparse_case(L, block, nc, num_pad, H=2, B=2, D=32, seed=0):
    """A random causal block layout with its diagonal and, for pad rows,
    block column 0; fp32 q, k, v, dO and a bias, from numpy."""
    rng = np.random.default_rng(seed)
    nb = -(-L // block)
    layout = (rng.uniform(size=(H, nb, nb)) < 0.5) & np.tril(np.ones((nb, nb), bool))
    for h in range(H):
        np.fill_diagonal(layout[h], True)
    if num_pad:
        layout[:, (L - num_pad) // block:, 0] = True
    q, k, v, do = (rng.standard_normal((B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    bias = rng.standard_normal((L, L)).astype(np.float32)
    return layout.astype(np.int64), q, k, v, do, bias


def _close_to_max(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rtol * float(np.abs(want).max()), rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_block_sparse_bwd_reference_matches_jax_kernel(case, with_bias):
    L, block, nc, num_pad, tile = BWD_CASES[case]
    layout, q, k, v, do, bias = _sparse_case(L, block, nc, num_pad)
    bias = bias if with_bias else None
    allowed = bs.allowed_mask(L, nc, num_pad).numpy().astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)
    jout, jlse = block_sparse_attention(
        jq, jk, jv, layout, allowed, jb, block=block, tile=tile,
        num_cond_tokens=nc, num_pad_tokens=num_pad, return_lse=True,
        interpret=True)
    want = block_sparse_attention_bwd(
        jq, jk, jv, layout, jb, jout, jdo, jlse, block=block, tile=tile,
        num_cond_tokens=nc, num_pad_tokens=num_pad, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    lt = torch.from_numpy(layout)
    out, lse = bs.block_sparse_attention_reference(tq, tk, tv, lt, block, nc,
                                                   num_pad, tb, return_lse=True)
    got = bs.block_sparse_attention_bwd_reference(tq, tk, tv, lt, block, nc,
                                                  num_pad, tb, out, tdo, lse)
    assert (got[3] is None) == (want[3] is None) == (bias is None)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is not None:
            _close_to_max(a.numpy(), w, BWD_RTOL, name)


@pytest.mark.parametrize("name", ["tiny-nuscenes", "tiny-rect", "nuscenes_ar"])
def test_transposed_tile_plan_visits_every_kept_pair_once(name):
    """The forward plan and its transpose list the same (q tile, key tile)
    pairs, each once, and together hold every pair the attention keeps: so
    the dq pass and the dk/dv pass each visit every kept pair exactly once.
    The transposed lists are ascending."""
    from bevgen_torch.core import config as tcfg
    from torch_parity import gpt_configs
    tc = {"tiny-nuscenes": lambda: gpt_configs(**NUSCENES_GPT)[1],
          "tiny-rect": lambda: ar_tiny_configs()[1].transformer,
          "nuscenes_ar": lambda: tcfg.PRESETS["nuscenes_ar"]().transformer}[name]()
    L, blk = tc.gpt_block_size, tc.sparse_block_size
    nc, npad = tc.num_cond_tokens, tc.num_pad_tokens
    layouts = tmasks.sparse_masks(tc).layouts
    plan = bs.plan_tiles(layouts, blk, L, nc, npad)
    plan_t = bs.plan_tiles(layouts, blk, L, nc, npad, transpose=True)
    H, nt = plan.counts.shape
    fwd, bwd = np.zeros((H, nt, nt), int), np.zeros((H, nt, nt), int)
    for h in range(H):
        for i in range(nt):
            np.add.at(fwd[h, i], plan.indices[h, i, :plan.counts[h, i]], 1)
            listed = plan_t.indices[h, i, :plan_t.counts[h, i]]
            assert (np.diff(listed) > 0).all()
            np.add.at(bwd[h, :, i], listed, 1)
    assert fwd.max() == 1
    np.testing.assert_array_equal(fwd, bwd)
    keep = bs.keep_mask(torch.from_numpy(layouts), blk, L, nc, npad)
    pad = nt * bs.TILE - L
    kept_tiles = torch.nn.functional.pad(keep, (0, pad, 0, pad)).reshape(
        H, nt, bs.TILE, nt, bs.TILE).any(4).any(2).numpy()
    assert (fwd[kept_tiles] == 1).all()


def _plain_launches(monkeypatch, calls):
    """The Function's two kernel launches, replaced by the plain versions
    (recording the plans they were given)."""
    def fwd(q, k, v, layout, counts, indices, full, block, nc, num_pad=0,
            bias=None, scale=None, return_lse=False):
        calls.append(("fwd", counts, indices))
        return bs.block_sparse_attention_reference(q, k, v, layout, block, nc,
                                                   num_pad, bias, scale,
                                                   return_lse)

    def bwd(q, k, v, layout, counts, indices, full, counts_t, indices_t,
            full_t, block, nc, num_pad, bias, out, do, lse, scale=None,
            need_dbias=True):
        calls.append(("bwd", counts_t, indices_t, need_dbias))
        dq, dk, dv, dbias = bs.block_sparse_attention_bwd_reference(
            q, k, v, layout, block, nc, num_pad, bias, out, do, lse, scale)
        return dq, dk, dv, dbias if need_dbias else None

    monkeypatch.setattr(bs, "block_sparse_attention_cuda", fwd)
    monkeypatch.setattr(bs, "block_sparse_attention_bwd_cuda", bwd)


@pytest.mark.parametrize("with_bias", [False, True])
def test_function_matches_autograd_through_the_plain_forward(monkeypatch,
                                                             with_bias):
    calls = []
    _plain_launches(monkeypatch, calls)
    L, block, nc, num_pad = 100, 16, 20, 6
    layout, q, k, v, do, bias = _sparse_case(L, block, nc, num_pad, seed=3)
    attn = bs.SparseAttention(layout, block, nc, num_pad)
    plan = attn.device_plan(L, torch.device("cpu"))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    if not with_bias:
        leaves = leaves[:3]
    b = leaves[3] if with_bias else None
    out = bs.BlockSparseAttentionFn.apply(*leaves[:3], b, plan, block, nc,
                                          num_pad, None)
    assert isinstance(out.grad_fn, bs.BlockSparseAttentionFn._backward_cls)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    assert calls[0][1] is plan.counts and calls[1][1] is plan.counts_t
    ref = bs.block_sparse_attention_reference(*leaves[:3], torch.from_numpy(layout),
                                              block, nc, num_pad, b)
    want = torch.autograd.grad(ref, leaves, torch.from_numpy(do))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_to_max(a.numpy(), w.numpy(), BWD_RTOL, name)


def test_function_skips_dbias_for_a_bias_without_gradient(monkeypatch):
    calls = []
    _plain_launches(monkeypatch, calls)
    L, block, nc, num_pad = 100, 16, 20, 6
    layout, q, k, v, do, bias = _sparse_case(L, block, nc, num_pad, seed=5)
    attn = bs.SparseAttention(layout, block, nc, num_pad)
    plan = attn.device_plan(L, torch.device("cpu"))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    b = torch.from_numpy(bias)
    out = bs.BlockSparseAttentionFn.apply(*leaves, b, plan, block, nc,
                                          num_pad, None)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert calls[1][0] == "bwd" and calls[1][3] is False
    ref = bs.block_sparse_attention_reference(*leaves, torch.from_numpy(layout),
                                              block, nc, num_pad, b)
    want = torch.autograd.grad(ref, leaves, torch.from_numpy(do))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close_to_max(a.numpy(), w.numpy(), BWD_RTOL, name)


def test_bbox_token_weights_equal_reference():
    _, _, _, tc = gpt_pair()
    rng = np.random.default_rng(4)
    H, W = tc.cam_res
    corners = rng.uniform(0, [W, H, W, H], size=(2, tc.num_cams, 3, 4))
    boxes = np.concatenate([np.minimum(corners[..., :2], corners[..., 2:]),
                            np.maximum(corners[..., :2], corners[..., 2:])],
                           axis=-1).astype(np.float32)
    want = np.asarray(jar.bbox_token_weights(tc, jnp.asarray(boxes), 2.0))
    got = tar.bbox_token_weights(tc, torch.from_numpy(boxes), 2.0).numpy()
    assert got.shape == (2, tc.num_img_tokens) and (got > 1).any() and (got == 1).any()
    np.testing.assert_array_equal(got, want)


def _loss_models(case):
    """(jax model, jax {'params': ...}, port SparseGPT, port cfg)."""
    if case == "ar-tiny":
        jp, params, tp = ar_tiny_pipelines()
        return jp.gpt, params["gpt"], tp.gpt, tp.gpt.cfg
    return gpt_pair()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["plain", "ar-tiny"])
def test_ar_loss_and_grads_match_jax(case, weighted):
    jm, jparams, tm, tc = _loss_models(case)
    assert case != "ar-tiny" or tc.camera_bias
    ids, cond, ii, ei = gpt_inputs(tc, b=2, seed=5)
    w = (np.random.default_rng(6).uniform(1, 3, (2, tc.num_img_tokens))
         .astype(np.float32) if weighted else None)

    def loss(p):
        return jar.ar_loss(jm, {"params": p}, *(jnp.asarray(a) for a in
                                                (ids, cond, ii, ei)),
                           weights=None if w is None else jnp.asarray(w),
                           deterministic=True)

    want, jgrads = jax.jit(jax.value_and_grad(loss))(jparams["params"])
    got = tar.ar_loss(tm, *(torch.from_numpy(a) for a in (ids, cond, ii, ei)),
                      weights=None if w is None else torch.from_numpy(w),
                      deterministic=True)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=LOSS_TOL,
                               rtol=0)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(got, [p for _, p in tm.named_parameters()])
    assert_trees_close(export_jax_params(tm, dict(zip(names, grads))), jgrads,
                       GRAD_RTOL, what="grad")


def test_ar_train_step_matches_jax_sharded_step():
    """Two AR train steps (loss, gradients, their norm, clip, AdamW) against
    the reference's make_ar_sharded_train_step on a dp=1 mesh. The first
    update has lr 0; the second moves each entry by about lr = 1e-3."""
    jm, jparams, tm, tc = gpt_pair(camera_bias=True)
    tm = copy.deepcopy(tm)
    ids, cond, ii, ei = gpt_inputs(tc, b=2, seed=7)
    jbatch = {"tokens": ids, "cond_ids": cond, "intrinsics_inv": ii,
              "extrinsics_inv": ei}
    tbatch = {k: torch.from_numpy(v) for k, v in jbatch.items()}
    lr = 1e-3
    params = jax.tree_util.tree_map(jnp.array, jparams)  # the step donates it
    tx = joptim.maskgit_optimizer(lr, warmup_steps=1, total_steps=10,
                                  params_example=params["params"])
    mesh = shd.make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    jstep, jstate = jtrainer.make_ar_sharded_train_step(
        jm, tx, mesh, jtrainer.create_ar_train_state(params, tx))
    opt = toptim.maskgit_optimizer(tm, lr, warmup_steps=1, total_steps=10)
    state = ttrainer.create_ar_train_state(tm, opt)
    step = ttrainer.make_ar_train_step()
    for _ in range(2):
        with mesh:
            jstate, jmetrics = jstep(jstate, shd.shard_batch(
                {k: jnp.asarray(v) for k, v in jbatch.items()}, mesh))
        metrics = step(state, tbatch)
        assert metrics.keys() == jmetrics.keys() == {"loss", "grad_norm"}
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 2 and opt.count == 2
    got, want = export_jax_params(tm), jax.device_get(jstate.params["params"])
    # the key projection's bias adds the same q.b to every score of a row,
    # which the softmax ignores: its gradient is fp32 noise on both sides,
    # and Adam turns noise into a step of up to lr in either direction
    for i in range(tc.num_layers):
        a = got[f"block_{i}"]["key"].pop("bias")
        b = want[f"block_{i}"]["key"].pop("bias")
        assert np.abs(a - np.asarray(b)).max() <= 2 * lr
    assert_steps_close(got, want, lr, "params")


def test_decay_mask_matches_jax_over_the_gpt_tree():
    _, jparams, tm, _ = _loss_models("ar-tiny")
    flags = toptim.decay_mask(tm)
    exported = export_jax_params(tm, {
        n: torch.full_like(p, float(flags[n])) for n, p in tm.named_parameters()})
    got = jax.tree_util.tree_map(lambda a: bool(a.flat[0]), exported)
    assert got == joptim.decay_mask(jparams["params"])
    decayed = {n for n, f in flags.items() if f}
    assert "head.weight" in decayed and "block_0.mlp_fc.weight" in decayed
    for name in ("camera_bias_emb", "x_pos_emb", "cond_pos_emb",
                 "x_tok_emb.weight", "img_embed.weight", "block_0.ln1.norm.bias"):
        assert name in flags and not flags[name], name


def test_dropout_only_when_not_deterministic():
    _, _, tm, tc = gpt_pair()
    drop = SparseGPT(dataclasses.replace(tc, embd_pdrop=0.2, resid_pdrop=0.3),
                     dtype=torch.float32)
    drop.load_state_dict(tm.state_dict())
    inputs = [torch.from_numpy(a) for a in gpt_inputs(tc, b=2, seed=8)]
    with torch.no_grad():
        base = tm(*inputs)
        assert torch.equal(drop(*inputs), base)   # deterministic by default
        runs = [drop(*inputs, deterministic=False,
                     generator=torch.Generator().manual_seed(s))
                for s in (0, 0, 1)]
        # pdrop 0 draws nothing and needs no generator
        assert torch.equal(tm(*inputs, deterministic=False), base)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.allclose(runs[0], base, atol=1e-3)
    with pytest.raises(ValueError, match="Generator"):
        drop(*inputs, deterministic=False)


def test_dropout_keeps_and_scales_as_flax():
    from bevgen_torch.models.stage2.gpt import dropout
    x = torch.ones(20000)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
