"""The reference's torch checkpoints in the PyTorch port, against the JAX
package on the CPU at tiny_test, fp32.

Synthetic checkpoints in the reference's key layout are made from flax
trees with the JAX tests' own inverse key maps (`_stage1_torch_key`,
`_muse_torch_key` of tests/test_checkpoint.py) and an inverse for the
sparse GPT's keys written here. Each converter of
`bevgen_torch/core/checkpoint.py` must give the JAX package's tree leaf for
leaf; `load_torch_checkpoint` the JAX loader's state dict; and a pipeline
loaded with `training/checkpoints.py:load_weights` the JAX pipeline's
greedy ids (images within 1e-4) after the JAX package loaded the same file.
Then the routing, the errors, `resolve_ema_path` over the port's tags,
the generate CLI's `ckpt_path=`/`ema=`, and `scripts/weights_drill.py`'s
inverse (the one phase 26 of chip_smoke.py writes its files with) against
the oracle.
"""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.core import checkpoint as jckpt
from bevgen_tpu.training import checkpoints as jtc
from bevgen_torch.core import checkpoint as tckpt
from bevgen_torch.core.convert import export_jax_params, load_jax_params
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.training import checkpoints as ttc
from test_checkpoint import _muse_torch_key, _stage1_torch_key
from torch_parity import (GREEDY, JaxPipeline, TorchPipeline, _jax_ar_pipeline,
                          ar_tiny_configs, ar_tiny_tree, tiny_configs, tiny_tree,
                          variant_configs, variant_tree)

SEED_A, SEED_B = 3, 4
IMG_TOL = 1e-4   # fp32 convolutions summed in another order


# ---- the oracle: flax trees -> reference torch keys ------------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _gpt_torch_key(path):
    """flax SparseGPT param path -> (torch key, to-torch layout function),
    the names of the reference's mingpt_sparse.py GPT."""
    parts = list(path)
    ident = lambda a: a
    lin = lambda a: a.T
    conv1x1 = lambda a: a.T[:, :, None, None]
    norm = {"scale": "weight", "bias": "bias"}
    if parts[0] in ("x_tok_emb", "cond_tok_emb"):
        return f"{parts[0]}.weight", ident
    if parts[0] in ("x_pos_emb", "cond_pos_emb", "bev_cam_pos_emb"):
        return parts[0], ident
    if parts[0] == "camera_bias_emb":
        return parts[0], lambda a: a[np.tril_indices(a.shape[0])][None]
    if parts[0] in ("img_embed", "cam_embed"):
        return f"{parts[0]}.weight", conv1x1
    if parts[0] == "bev_embed":
        return (("bev_embed.weight", conv1x1) if parts[1] == "kernel"
                else ("bev_embed.bias", ident))
    if parts[0] == "ln_f":
        return f"ln_f.{norm[parts[-1]]}", ident
    if parts[0] == "head":
        return "head.weight", lin
    i = re.fullmatch(r"block_(\d+)", parts[0]).group(1)
    sub, leaf = parts[1], parts[-1]
    if sub in ("ln1", "ln2"):
        return f"blocks.{i}.{sub}.{norm[leaf]}", ident
    owner = {"query": "attention.query", "key": "attention.key",
             "value": "attention.value", "mlp_fc": "mlp.0",
             "mlp_proj": "mlp.2"}[sub]
    if leaf == "kernel":
        return f"blocks.{i}.{owner}.weight", lin
    return f"blocks.{i}.{owner}.bias", ident


_SELF_COND_IDX = {"norm_in": "0", "proj_in": "1", "norm_mid": "3",
                  "proj_out": "4"}


def _muse_key(path):
    """`_muse_torch_key`, and the `self_cond_to_init_embed` GEGLU's keys
    (muse_maskgit_pytorch.py:241), which that oracle does not map."""
    if path[0] != "self_cond_to_init_embed":
        return _muse_torch_key(path)
    key = f"self_cond_to_init_embed.{_SELF_COND_IDX[path[1]]}"
    if path[-1] == "scale":
        return f"{key}.gamma", lambda a: a
    return f"{key}.weight", lambda a: a.T


def _torch_state(tree, keymap, prefix=""):
    out = {}
    for path, val in _flat(tree):
        key, fn = keymap(list(path))
        out[prefix + key] = np.ascontiguousarray(fn(val))
    return out


def muse_state(tree, critic="self"):
    """A reference MUSE Net2NetTransformer state dict of a pipeline tree:
    the SelfCritic's `net.*` aliases and `to_pred` head (critic="self"), or
    a separate TokenCritic transformer (critic="token": the tree's
    `token_critic`, or a copy of the generator's when it has none)."""
    mg = tree["maskgit"]["params"]
    state = {}
    state.update(_torch_state(tree["first_stage"]["params"], _stage1_torch_key,
                              "first_stage_model."))
    state.update(_torch_state(tree["cond_stage"]["params"], _stage1_torch_key,
                              "cond_stage_model."))
    tf = _torch_state(mg["transformer"], _muse_key)
    state.update({f"maskgit.transformer.{k}": v for k, v in tf.items()})
    if critic == "self":
        state.update({f"maskgit.token_critic.net.{k}": v for k, v in tf.items()})
        head = mg["critic"]["to_pred"]
        state["maskgit.token_critic.to_pred.weight"] = np.asarray(head["kernel"]).T
        state["maskgit.token_critic.to_pred.bias"] = np.asarray(head["bias"])
    else:
        crit = (_torch_state(mg["token_critic"], _muse_key)
                if "token_critic" in mg else tf)
        state.update({f"maskgit.token_critic.{k}": v for k, v in crit.items()})
    return state


def ar_state(tree):
    """A reference AR Net2NetTransformer state dict of an ARPipeline tree."""
    state = {}
    state.update(_torch_state(tree["first_stage"]["params"], _stage1_torch_key,
                              "first_stage_model."))
    state.update(_torch_state(tree["cond_stage"]["params"], _stage1_torch_key,
                              "cond_stage_model."))
    state.update(_torch_state(tree["gpt"]["params"], _gpt_torch_key,
                              "transformer."))
    return state


def save_lightning(path, state, prefix=""):
    torch.save({"state_dict": {prefix + k: torch.from_numpy(np.array(v))
                               for k, v in state.items()},
                "epoch": 3, "global_step": 120}, str(path))
    return str(path)


def assert_trees_equal(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys(), (sorted(set(g) ^ set(w))[:8])
    for k in w:
        assert np.array_equal(g[k], w[k]), k


def _self_cond_keys(dim, rng):
    """The `self_cond_to_init_embed.*` keys every reference checkpoint holds
    (muse_maskgit_pytorch.py:241): a GEGLU feed-forward with its norms."""
    inner = 2 * dim
    return {"self_cond_to_init_embed.0.gamma": rng.standard_normal(dim),
            "self_cond_to_init_embed.0.beta": np.zeros(dim),
            "self_cond_to_init_embed.1.weight": rng.standard_normal((2 * inner, dim)),
            "self_cond_to_init_embed.3.gamma": rng.standard_normal(inner),
            "self_cond_to_init_embed.3.beta": np.zeros(inner),
            "self_cond_to_init_embed.4.weight": rng.standard_normal((dim, inner))}


# ---- converter parity ------------------------------------------------------

@pytest.mark.parametrize("part", ["first_stage", "cond_stage"])
def test_convert_stage1_matches_jax(part):
    tree = tiny_tree(SEED_A)[part]["params"]
    state = _torch_state(tree, _stage1_torch_key)
    state["loss.perceptual.w"] = np.ones(3, np.float32)   # skipped by both
    got = tckpt.convert_stage1(state)
    assert_trees_equal(got, jckpt.convert_stage1(state))
    assert_trees_equal(got, tree)


@pytest.mark.parametrize("self_cond", [False, True])
def test_convert_muse_transformer_matches_jax(self_cond):
    tree = tiny_tree(SEED_A)["maskgit"]["params"]["transformer"]
    state = _torch_state(tree, _muse_torch_key)
    dim = tree["token_emb"]["embedding"].shape[1]
    state.update(_self_cond_keys(dim, np.random.default_rng(0)))
    state["transformer_blocks.layers.0.0.norm.beta"] = np.zeros(dim)
    got = tckpt.convert_muse_transformer(state, self_cond=self_cond)
    assert_trees_equal(got, jckpt.convert_muse_transformer(state,
                                                           self_cond=self_cond))
    assert ("self_cond_to_init_embed" in got) == self_cond
    # the flat-tril camera bias comes back as the (L, L) table's tril
    L = tree["camera_bias_emb"].shape[0]
    assert got["camera_bias_emb"].shape == (L, L)
    np.testing.assert_array_equal(got["camera_bias_emb"],
                                  np.tril(tree["camera_bias_emb"]))


def test_scatter_tril_matches_jax():
    flat = np.arange(1, 22, dtype=np.float32)[None]     # L = 6
    got = tckpt._scatter_tril(flat)
    np.testing.assert_array_equal(got, jckpt._scatter_tril(flat))
    assert got.shape == (6, 6) and got[5, 5] == 21 and got[0, 1] == 0


def test_convert_gpt_matches_jax():
    tree = ar_tiny_tree(SEED_A)["gpt"]["params"]
    state = _torch_state(tree, _gpt_torch_key)
    state["blocks.0.attention.sparse_self_attention.master_layout"] = \
        np.ones((2, 3, 3), np.float32)                   # rebuilt from config
    got = tckpt.convert_gpt(state)
    assert_trees_equal(got, jckpt.convert_gpt(state))
    want = dict(tree, camera_bias_emb=np.tril(tree["camera_bias_emb"]))
    assert_trees_equal(got, want)


@pytest.mark.parametrize("critic", ["self", "token"])
def test_convert_net2net_matches_jax(critic):
    tree = tiny_tree(SEED_A)
    state = muse_state(tree, critic)
    state["maskgit.mask_schedule_buffer"] = np.zeros(4, np.float32)
    state = {f"_forward_module.{k}": v for k, v in state.items()}
    got = tckpt.convert_net2net(state)
    assert_trees_equal(got, jckpt.convert_net2net(state))
    mg = got["maskgit"]["params"]
    assert set(mg) == ({"transformer", "critic"} if critic == "self"
                       else {"transformer", "token_critic"})


def test_convert_ar_net2net_matches_jax():
    state = ar_state(ar_tiny_tree(SEED_A))
    got = tckpt.convert_ar_net2net(state)
    assert_trees_equal(got, jckpt.convert_ar_net2net(state))
    assert set(got) == {"first_stage", "cond_stage", "gpt"}


def test_tree_utilities_match_jax():
    tree = tiny_tree(SEED_A)
    other = tiny_tree(SEED_B)
    del other["maskgit"]["params"]["critic"]
    assert tckpt.tree_shapes(tree) == jckpt.tree_shapes(tree)
    assert tckpt.verify_tree_match(other, tree) == \
        jckpt.verify_tree_match(other, tree)
    missing, unexpected = tckpt.verify_tree_match(other, tree)
    assert missing and not unexpected


@pytest.mark.parametrize("convert,key", [
    (tckpt.convert_stage1, "encoder.nowhere.0.weight"),
    (tckpt.convert_muse_transformer, "mystery.weight"),
    (tckpt.convert_gpt, "blocks.0.mystery.weight"),
    (tckpt.convert_net2net, "optimizer_thing"),
    (tckpt.convert_ar_net2net, "maskgit.transformer.pos_emb.weight"),
])
def test_unknown_keys_raise_where_the_reference_prints(convert, key):
    """The reference prints and skips a key it does not know; the port
    raises, naming it."""
    with pytest.raises(KeyError, match=re.escape(key.split(".")[0])):
        convert({key: np.zeros((2, 2), np.float32)})


# ---- the loader ------------------------------------------------------------

def test_load_torch_checkpoint_lightning_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    state = {"first_stage_model.quantize.embedding.weight":
             rng.standard_normal((8, 4)).astype(np.float32),
             "transformer.x_pos_emb": rng.standard_normal((1, 5, 4)).astype(np.float32)}
    path = save_lightning(tmp_path / "run.ckpt", state, "_forward_module.")
    got = tckpt.load_torch_checkpoint(path)
    want = jckpt.load_torch_checkpoint(path)
    assert got.keys() == want.keys() == state.keys()
    for k in state:
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k], state[k])


@pytest.mark.parametrize("with_latest", [True, False])
def test_load_torch_checkpoint_zero_directory_matches_jax(tmp_path, with_latest):
    """A DeepSpeed ZeRO directory with two tags: `latest` names the older
    one (so neither string order nor modification time would find it);
    without it the newest file wins in both packages."""
    import os
    import time
    for i, tag in enumerate(("global_step500", "global_step1000")):
        d = tmp_path / tag
        d.mkdir()
        module = {"_forward_module.transformer.x_pos_emb":
                  torch.full((1, 2, 3), float(i))}
        torch.save({"module": module, "optimizer": None},
                   str(d / "mp_rank_00_model_states.pt"))
        os.utime(d / "mp_rank_00_model_states.pt", (time.time() + i,) * 2)
    if with_latest:
        (tmp_path / "latest").write_text("global_step500\n")
    got = tckpt.load_torch_checkpoint(str(tmp_path))
    want = jckpt.load_torch_checkpoint(str(tmp_path))
    assert got.keys() == want.keys() == {"transformer.x_pos_emb"}
    assert np.array_equal(got["transformer.x_pos_emb"], want["transformer.x_pos_emb"])
    assert got["transformer.x_pos_emb"].flat[0] == (0.0 if with_latest else 1.0)


def test_load_torch_checkpoint_reads_bf16_as_fp32(tmp_path):
    t = torch.randn(3, 4).bfloat16()
    torch.save({"state_dict": {"transformer.x_pos_emb": t}}, str(tmp_path / "a.pt"))
    got = tckpt.load_torch_checkpoint(str(tmp_path / "a.pt"))["transformer.x_pos_emb"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, t.float().numpy())


# ---- end to end: one file, both packages -----------------------------------

def _port_muse(seed):
    return TorchPipeline.create(tiny_configs(greedy=True)[1], device="cpu",
                                dtype=torch.float32).init_params(seed)


def _port_ar(seed):
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    return ARPipeline.create(ar_tiny_configs()[1], device="cpu",
                             dtype=torch.float32).init_params(seed)


def _snapshot(pipe):
    return {n: p.detach().clone() for n, p in pipe.named_parameters()}


def _assert_loaded(pipe, before, want_tree):
    """The pipeline holds `want_tree` leaf for leaf, and every parameter
    moved away from the seeded values it held before the load."""
    assert_trees_equal(export_jax_params(pipe), want_tree)
    same = [n for n, p in pipe.named_parameters() if torch.equal(p, before[n])]
    assert not same, same[:5]


@pytest.fixture(scope="module")
def muse_ckpt(tmp_path_factory):
    """A reference MUSE checkpoint of the JAX weights of seed A, and the
    tree the JAX package loads from it."""
    path = save_lightning(tmp_path_factory.mktemp("muse") / "muse.ckpt",
                          muse_state(tiny_tree(SEED_A)), "_forward_module.")
    jp = JaxPipeline.create(tiny_configs(greedy=True)[0], dtype=jnp.float32)
    example = jax.eval_shape(jp.init_params, jax.random.PRNGKey(0))
    return path, jp, jtc.load_weights(path, example)


@pytest.fixture(scope="module")
def ar_ckpt(tmp_path_factory):
    path = save_lightning(tmp_path_factory.mktemp("ar") / "ar.ckpt",
                          ar_state(ar_tiny_tree(SEED_A)))
    jp = _jax_ar_pipeline()
    example = jax.eval_shape(jp.init_params, jax.random.PRNGKey(0))
    return path, jp, jtc.load_weights(path, example)


def test_muse_checkpoint_generates_as_jax(muse_ckpt):
    path, jp, jtree = muse_ckpt
    tp = _port_muse(SEED_B)
    before = _snapshot(tp)
    assert ttc.load_weights(path, tp) == "muse"
    _assert_loaded(tp, before, jtree)
    batch = fake_batch(tp.config, 2, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    params = jax.tree_util.tree_map(jnp.asarray, jtree)
    want_img, want_ids = jax.jit(jp.generate_fn)(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei),
        jax.random.PRNGKey(0))
    got_img, got_ids = tp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


def test_ar_checkpoint_generates_as_jax(ar_ckpt):
    path, jp, jtree = ar_ckpt
    tp = _port_ar(SEED_B)
    before = _snapshot(tp)
    assert ttc.load_weights(path, tp) == "ar"
    _assert_loaded(tp, before, jtree)
    batch = fake_batch(tp.config, 2, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    params = jax.tree_util.tree_map(jnp.asarray, jtree)
    want_img, want_ids = jax.jit(lambda p, s, i, e: jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), top_k=1))(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei))
    got_img, got_ids = tp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0),
                                      top_k=1)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


# ---- routing and errors ----------------------------------------------------

def test_bare_stage1_checkpoint_grafts_into_first_stage(tmp_path):
    tree = tiny_tree(SEED_A)
    path = save_lightning(tmp_path / "vq.ckpt", _torch_state(
        tree["first_stage"]["params"], _stage1_torch_key), "_forward_module.")
    tp = _port_muse(SEED_B)
    before = _snapshot(tp)
    assert ttc.load_weights(path, tp) == "stage1"
    got = export_jax_params(tp)
    assert_trees_equal(got["first_stage"], tree["first_stage"])
    for name, p in tp.named_parameters():
        moved = not torch.equal(p, before[name])
        assert moved == name.startswith("first_stage."), name


def test_unknown_family_raises(tmp_path):
    path = save_lightning(tmp_path / "bogus.ckpt",
                          {"who.knows": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="unrecognized"):
        ttc.load_weights(path, _port_muse(SEED_B))


def test_token_critic_checkpoint_raises_naming_it(tmp_path):
    """A separate TokenCritic is not dropped by a pipeline built without one
    (the SelfCritic's): the load names its leaves."""
    path = save_lightning(tmp_path / "tc.ckpt",
                          muse_state(tiny_tree(SEED_A), critic="token"))
    with pytest.raises(KeyError, match="token_critic"):
        ttc.load_weights(path, _port_muse(SEED_B))


def test_self_cond_leaves_raise_naming_them(tmp_path):
    """The `self_cond_to_init_embed.*` keys of a reference checkpoint are
    converted only for a pipeline that holds the module, as in the
    reference: a pipeline built without `self_cond` does not, so
    load_weights leaves them out; converted, they raise, named."""
    tree = tiny_tree(SEED_A)
    state = muse_state(tree)
    dim = tree["maskgit"]["params"]["transformer"]["token_emb"]["embedding"].shape[1]
    state.update({f"maskgit.transformer.{k}": v for k, v in
                  _self_cond_keys(dim, np.random.default_rng(2)).items()})
    tp = _port_muse(SEED_B)
    with pytest.raises(KeyError, match="self_cond_to_init_embed"):
        load_jax_params(tp, tckpt.convert_net2net(state, self_cond=True))
    path = save_lightning(tmp_path / "sc.ckpt", state)
    assert ttc.load_weights(path, tp) == "muse"


@pytest.mark.parametrize("variant", ["token_critic", "self_cond",
                                     "self_cond+token_critic"])
def test_variant_checkpoint_generates_as_jax(variant, tmp_path):
    """A reference checkpoint with a separate TokenCritic, or with the
    `self_cond_to_init_embed` weights, loads into a pipeline built with that
    module and gives the JAX pipeline's greedy ids from the same file."""
    tree = variant_tree(variant, SEED_A)
    critic = "token" if "token_critic" in tree["maskgit"]["params"] else "self"
    path = save_lightning(tmp_path / "v.ckpt", muse_state(tree, critic),
                          "_forward_module.")
    jc, tc = variant_configs(variant, greedy=True)
    jp = JaxPipeline.create(jc, dtype=jnp.float32)
    jtree = jtc.load_weights(path, jax.eval_shape(jp.init_params,
                                                  jax.random.PRNGKey(0)))
    tp = TorchPipeline.create(tc, device="cpu",
                              dtype=torch.float32).init_params(SEED_B)
    before = _snapshot(tp)
    assert ttc.load_weights(path, tp) == "muse"
    _assert_loaded(tp, before, jtree)
    batch = fake_batch(tp.config, 2, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    want_img, want_ids = jax.jit(jp.generate_fn)(
        jax.tree_util.tree_map(jnp.asarray, jtree), jnp.asarray(seg),
        jnp.asarray(ii), jnp.asarray(ei), jax.random.PRNGKey(0))
    got_img, got_ids = tp.generate_fn(seg, ii, ei,
                                      torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


def test_muse_checkpoint_into_ar_pipeline_raises(muse_ckpt):
    with pytest.raises(KeyError, match="gpt"):
        ttc.load_weights(muse_ckpt[0], _port_ar(SEED_B))


def _port_run(tmp_path, pipe, steps=(2, 5), latest=5):
    """A run directory of the port's tags: state.pt and an -EMA sibling per
    step (the EMA of step s: the weights times s)."""
    state = types.SimpleNamespace(
        model=pipe.maskgit, step=0,
        optimizer=types.SimpleNamespace(state_dict=lambda: {}))
    mgr = ttc.CheckpointManager(str(tmp_path), keep_last=5)
    for s in steps:
        state.step = s
        mgr.save_step(s, state, force=True)
        mgr.save_ema(s, {n: p * s for n, p in pipe.maskgit.named_parameters()})
    (tmp_path / "LATEST").write_text(f"step_{latest:08d}")
    return tmp_path


def test_resolve_ema_path(tmp_path):
    run = _port_run(tmp_path / "run", _port_muse(SEED_A), latest=2)
    step2, step5 = run / "step_00000002", run / "step_00000005"
    assert ttc.resolve_ema_path(str(step5)) == str(step5) + "-EMA"
    assert ttc.resolve_ema_path(str(run)) == str(step2) + "-EMA"   # LATEST
    assert ttc.resolve_ema_path(str(step2) + "-EMA") == str(step2) + "-EMA"
    (run / "LATEST").unlink()
    assert ttc.resolve_ema_path(str(run)) == str(step5) + "-EMA"   # newest
    import shutil
    shutil.rmtree(str(step5) + "-EMA")
    with pytest.raises(FileNotFoundError):
        ttc.resolve_ema_path(str(step5))
    with pytest.raises(FileNotFoundError):
        ttc.resolve_ema_path(str(run))      # the newest step has no EMA
    with pytest.raises(FileNotFoundError):
        ttc.resolve_ema_path(str(tmp_path / "empty.ckpt"))


def test_port_tags_load_strictly(tmp_path):
    src = _port_muse(SEED_A)
    run = _port_run(tmp_path / "run", src, latest=5)
    tp = _port_muse(SEED_B)
    assert ttc.load_weights(str(run / "step_00000005"), tp) == "port"
    for (n, a), b in zip(src.maskgit.named_parameters(), tp.maskgit.parameters()):
        assert torch.equal(a, b), n
    ema = ttc.resolve_ema_path(str(run / "step_00000002"))
    assert ttc.load_weights(ema, tp) == "port-ema"
    for (n, a), b in zip(src.maskgit.named_parameters(), tp.maskgit.parameters()):
        assert torch.equal(a * 2, b), n
    bad = torch.load(run / "step_00000002" / "state.pt", weights_only=False)
    bad["params"]["extra"] = torch.zeros(1)
    torch.save(bad, run / "step_00000002" / "state.pt")
    with pytest.raises(RuntimeError, match="extra"):
        ttc.load_weights(str(run / "step_00000002"), tp)


# ---- the CLI -------------------------------------------------------------

def test_cli_ema_without_ckpt_path_exits():
    from bevgen_torch.scripts import generate as cli
    with pytest.raises(SystemExit, match="ckpt_path"):
        cli.main(["preset=tiny_test", "device=cpu", "ema=true"])


GREEDY_ARGS = [f"muse.{k}={v}" for k, v in GREEDY.items()]


def test_cli_serves_the_checkpoint(muse_ckpt, tmp_path, capsys):
    """The CLI with seed B and ckpt_path writes the ids of the seed-A
    weights: the JAX package's greedy ids on the same batch."""
    from bevgen_torch.scripts import generate as cli
    path, jp, jtree = muse_ckpt
    assert cli.main(["preset=tiny_test", "batch_size=2", "fake=1",
                     f"seed={SEED_B}", "device=cpu", f"ckpt_path={path}",
                     f"out={tmp_path}", "dtype=float32", *GREEDY_ARGS]) == 0
    assert f"loaded muse weights from {path}" in capsys.readouterr().out
    got = np.load(tmp_path / "batch_0000.npz")["ids"]
    batch = fake_batch(tiny_configs(greedy=True)[1], 2, seed=SEED_B)
    params = jax.tree_util.tree_map(jnp.asarray, jtree)
    _, want = jax.jit(jp.generate_fn)(
        params, *(jnp.asarray(batch[k]) for k in ("segmentation",
                                                  "intrinsics_inv",
                                                  "extrinsics_inv")),
        jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cli_ar_and_ema(tmp_path, capsys):
    """`pipeline=ar` takes a reference checkpoint (written here from a port
    pipeline of seed A with the weights drill's writer), and `ema=true` a port
    run's EMA weights."""
    from bevgen_torch.scripts import generate as cli
    from bevgen_torch.scripts.weights_drill import write_reference_ckpt
    from test_torch_ar import TINY_AR_CLI
    base = TINY_AR_CLI + ["batch_size=1", "fake=1", "device=cpu"]
    src, _ = cli.run(base + [f"seed={SEED_A}", f"out={tmp_path / 'a'}"])
    ckpt = tmp_path / "ar.ckpt"
    write_reference_ckpt(src, str(ckpt))
    _, outs = cli.run(base + [f"seed={SEED_B}", f"ckpt_path={ckpt}",
                              f"out={tmp_path / 'b'}"])
    assert "loaded ar weights" in capsys.readouterr().out
    batch = fake_batch(src.config, 1, seed=SEED_B)
    _, want = src.generate_fn(batch["segmentation"], batch["intrinsics_inv"],
                              batch["extrinsics_inv"],
                              torch.Generator().manual_seed(SEED_B))
    np.testing.assert_array_equal(np.load(outs[0])["ids"], want.numpy())

    muse = _port_muse(SEED_A)
    run = _port_run(tmp_path / "run", muse, latest=5)
    pipe, _ = cli.run(["preset=tiny_test", "fake=1", "device=cpu",
                       f"seed={SEED_B}", f"ckpt_path={run}", "ema=true",
                       "muse.sample_iterations=2", f"out={tmp_path / 'd'}"])
    assert "loaded port-ema weights" in capsys.readouterr().out
    for (n, a), b in zip(muse.maskgit.named_parameters(),
                         pipe.maskgit.parameters()):
        assert torch.equal((a * 5).to(b.dtype), b), n


# ---- the weights drill's inverse (phase 26 of chip_smoke.py writes with it) --

@pytest.mark.parametrize("family", ["muse", "ar", "token_critic",
                                    "self_cond+token_critic"])
def test_chip_smoke_reference_state_dict_matches_oracle(family):
    """The writer against the oracle: the MUSE and AR pipelines, and the
    MUSE variants phase 26 writes (a TokenCritic, self-conditioning)."""
    from bevgen_torch.scripts.weights_drill import reference_state_dict
    tree = {"muse": tiny_tree, "ar": ar_tiny_tree}.get(
        family, lambda seed: variant_tree(family, seed))(SEED_A)
    critic = "token" if family.endswith("token_critic") else "self"
    want = ar_state(tree) if family == "ar" else muse_state(tree, critic)
    got = reference_state_dict(tree)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:8]
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    if family == "muse":   # the SelfCritic aliases are the same arrays
        k = next(k for k in got if k.startswith("maskgit.transformer."))
        assert got[k] is got[k.replace("transformer.", "token_critic.net.", 1)]
    if family == "self_cond+token_critic":
        assert any(k.startswith("maskgit.token_critic.self_cond_to_init_embed.")
                   for k in got)
