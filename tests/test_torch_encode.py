"""Image encode, the stage-1 geometric embedding, partial decode and the
rectangular configuration of the PyTorch port against the JAX reference at
tiny sizes, fp32 on the CPU, on one numpy weight tree.

Held exactly: `encode_images` indices (MUSE tiny_test and the rectangular AR
tiny pipeline); with the geometric embedding, the JAX `VQModel` built and
initialised alone with the camera matrices (no JAX pipeline can hold it),
its `geometric_features` to 1e-5 and its indices; greedy ids of a
`keep_cameras` partial decode for MUSE and AR, with the kept cameras equal
to their encoded tokens; greedy ids of a rectangular (32x48 images, 4x6
latents) MUSE pipeline. Port-side: the reference's torch checkpoint keys of
the embedding load into the module, the generate CLI's `keep_cameras` and
`save_rec`, and the `argoverse_muse_rect` preset equals the JAX one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.core import config as jcfg
from bevgen_tpu.models.stage1.vq import VQModel as JaxVQ
from bevgen_tpu.models.stage1.vq import generate_plane as jax_plane
from bevgen_torch.core import config as tcfg
from bevgen_torch.core.convert import load_jax_params
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.models.stage1.vq import VQModel, generate_plane
from bevgen_torch.pipelines.generate import BEVGenPipeline
from bevgen_torch.scripts.generate import init_ids_keeping
from torch_parity import (ar_tiny_pipelines, random_tree, rect_pipelines,
                          tiny_pipelines)

GEO_TOL = 1e-5     # the normalised ray embedding, fp32
IMG_TOL = 1e-4     # fp32 convolutions summed in another order
B = 2


def _images(cfg, seed):
    tf = cfg.transformer
    return np.random.default_rng(seed).standard_normal(
        (B, tf.num_cams) + tuple(tf.cam_res) + (3,)).astype(np.float32)


def test_encode_images_matches_jax():
    jp, params, tp = tiny_pipelines()
    img = _images(tp.config, 0)
    want = np.asarray(jax.jit(jp.encode_images)(params, jnp.asarray(img)))
    got = tp.encode_images(img)
    assert got.dtype == torch.int64 and not got.requires_grad
    assert got.shape == (B, 3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ar_pipeline_encode_images_rectangular_matches_jax():
    jp, params, tp = ar_tiny_pipelines()
    img = _images(tp.config, 1)
    want = np.asarray(jax.jit(jp.encode_images)(params, jnp.asarray(img)))
    got = tp.encode_images(torch.from_numpy(img))
    assert got.shape == (B, 3, 24)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the geometric embedding -------------------------------------------------

def _geo_configs(rect=False):
    """(JAX, port) tiny first-stage configs with the embedding on
    (cam_emd_dim = z_channels); `rect`: 32x48 images, 4x6 latents."""
    extra = dict(cam_res=(32, 48), cam_latent_res=(4, 6)) if rect else {}
    return tuple(dataclasses.replace(
        m.tiny_test_config().first_stage, geometric_embedding=True,
        cam_emd_dim=16, **extra) for m in (jcfg, tcfg))


def _geo_inputs(cfg, seed):
    """Images (b*cam, H, W, 3) and the per-image inverse camera matrices of a
    rig with random yaws and offsets (so every ray term takes part)."""
    from bevgen_torch.models import geometry
    rng = np.random.default_rng(seed)
    n = 6
    x = rng.standard_normal((n,) + tuple(cfg.cam_res) + (3,)).astype(
        np.float32)
    intr, extr = geometry.canonical_camera_rig(
        tcfg.tiny_test_config().transformer)
    K = np.concatenate([intr, intr])
    E = np.concatenate([extr, extr]).copy()
    E[:, :3, 3] += rng.normal(0, 0.5, (n, 3))
    ii = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    ei = np.linalg.inv(E.astype(np.float64)).astype(np.float32)
    return x, ii, ei


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_geometric_embedding_matches_jax(rect):
    jc, tc = _geo_configs(rect)
    np.testing.assert_array_equal(generate_plane(tc), jax_plane(jc))
    x, ii, ei = _geo_inputs(tc, seed=2)
    jm = JaxVQ(jc)
    tree = random_tree(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), intrinsics_inv=jnp.asarray(ii),
        extrinsics_inv=jnp.asarray(ei))), seed=3)
    assert {"img_embed", "cam_embed"} <= set(tree["params"])
    tm = load_jax_params(VQModel(tc), tree).eval()
    np.testing.assert_array_equal(
        tm.img_embed.weight.detach().numpy(),
        tree["params"]["img_embed"]["kernel"].transpose(3, 2, 0, 1))
    assert tm.img_embed.bias is None and tm.cam_embed.bias is None
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want_geo = np.asarray(jm.apply(params, jnp.asarray(ii), jnp.asarray(ei),
                                   method=JaxVQ.geometric_features))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ii), jnp.asarray(ei),
                    method=JaxVQ.encode)
    tx, tii, tei = (torch.from_numpy(a) for a in (x, ii, ei))
    with torch.no_grad():
        geo = tm.geometric_features(tii, tei)
        got = tm.encode(tx, tii, tei)
    h, w = tc.cam_latent_res
    assert geo.shape == (6, h, w, 16)
    np.testing.assert_allclose(geo.numpy(), want_geo, atol=GEO_TOL, rtol=0)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    # the embedding takes part: the rays' unit vectors differ over the grid
    assert float(geo.std(dim=(1, 2)).min()) > 0
    with pytest.raises(ValueError, match="intrinsics_inv and extrinsics_inv"):
        tm.encode(tx)
    with pytest.raises(ValueError, match="intrinsics_inv and extrinsics_inv"):
        tm.encode(tx, tii)


def test_pipeline_encode_images_with_embedding_raises():
    """As in the reference, `encode_images` passes no camera matrices: a
    first stage with the embedding needs `VQModel.encode` with them."""
    cfg = tcfg.tiny_test_config()
    cfg = dataclasses.replace(cfg, first_stage=_geo_configs()[1])
    pipe = BEVGenPipeline.create(cfg, device="cpu", dtype="float32")
    pipe.init_params(0)
    with pytest.raises(ValueError, match="geometric_embedding"):
        pipe.encode_images(_images(cfg, 0))


def test_reference_checkpoint_keys_of_the_embedding_load():
    """The reference's torch keys `img_embed.weight`/`cam_embed.weight`
    (OIHW 1x1 convs) go through `convert_stage1` into the module."""
    from bevgen_torch.core.checkpoint import convert_stage1
    tc = _geo_configs()[1]
    src = VQModel(tc)
    from bevgen_torch.models.init import init_weights
    init_weights(src, 4)
    state = {k: v.detach().numpy() for k, v in src.state_dict().items()
             if k.split(".")[0] in ("img_embed", "cam_embed")}
    tree = convert_stage1(state)
    for name in ("img_embed", "cam_embed"):
        w = tree[name]["kernel"].transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(w, state[f"{name}.weight"])


# ---- partial decode ----------------------------------------------------------

def _kept_init(gt, kept, mask_id):
    """The JAX CLI's init_ids (bevgen_tpu/scripts/generate.py:175-183)."""
    init = jnp.full_like(gt, mask_id)
    for c in kept:
        init = init.at[:, c].set(gt[:, c])
    return init


@pytest.mark.parametrize("kept", [[0], [0, 2]], ids=["one", "two"])
def test_muse_partial_decode_greedy_matches_jax(kept):
    jp, params, tp = tiny_pipelines(greedy=True)
    tf = tp.config.transformer
    batch = fake_batch(tp.config, B, seed=3)
    seg, ii, ei, img = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                           "extrinsics_inv", "image"))
    gt = jp.encode_images(params, jnp.asarray(img))
    want_img, want = jax.jit(lambda p, s, i, e, init: jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), init_ids=init))(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei),
        _kept_init(gt, kept, tf.mask_token_id))
    tgt = tp.encode_images(img)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(gt))
    got_img, got = tp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0),
                                  init_ids=init_ids_keeping(
                                      tgt, kept, tf.mask_token_id))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = got.reshape(B, tf.num_cams, -1)
    np.testing.assert_array_equal(flat[:, kept].numpy(), tgt[:, kept].numpy())
    assert int(got.max()) < tf.vocab_size
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


def test_ar_partial_decode_greedy_matches_jax():
    jp, params, tp = ar_tiny_pipelines()
    tf = tp.config.transformer
    kept = [1]
    batch = fake_batch(tp.config, B, seed=4)
    seg, ii, ei, img = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                           "extrinsics_inv", "image"))
    gt = jp.encode_images(params, jnp.asarray(img))
    _, want = jax.jit(lambda p, s, i, e, init: jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), top_k=1, init_ids=init))(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei),
        _kept_init(gt, kept, tf.mask_token_id))
    tgt = tp.encode_images(img)
    init = init_ids_keeping(tgt, kept, tf.mask_token_id)
    for cached in (True, False):
        _, got = tp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0),
                                top_k=1, init_ids=init, cached=cached)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        flat = got.reshape(B, tf.num_cams, -1)
        np.testing.assert_array_equal(flat[:, kept].numpy(),
                                      tgt[:, kept].numpy())


def test_cli_keep_cameras_and_save_rec(tmp_path):
    from bevgen_torch.scripts import generate as cli
    pipe, paths = cli.run([
        "preset=tiny_test", "batch_size=2", "fake=1", "device=cpu",
        "dtype=float32", "muse.sample_iterations=2", f"out={tmp_path}",
        "keep_cameras=ring_front_right,ring_front_left", "save_rec=true"])
    out = np.load(paths[0])
    tf = pipe.config.transformer
    batch = fake_batch(pipe.config, 2, seed=0)
    gt = pipe.encode_images(batch["image"]).numpy()
    ids = out["ids"].reshape(2, tf.num_cams, -1)
    np.testing.assert_array_equal(ids[:, [0, 2]], gt[:, [0, 2]])
    assert ids.max() < tf.vocab_size
    assert out["rec"].shape == batch["image"].shape
    rec = pipe.decode_tokens(torch.from_numpy(gt.reshape(2, 3, 4, 4)))
    np.testing.assert_array_equal(out["rec"], rec.numpy())
    with pytest.raises(SystemExit, match="ring_rear_left"):
        cli.run(["preset=tiny_test", "fake=1", "device=cpu",
                 "keep_cameras=ring_rear_left", f"out={tmp_path}"])


# ---- the rectangular configuration -------------------------------------------

def test_rect_greedy_generate_matches_jax():
    jp, params, tp = rect_pipelines(greedy=True)
    tf = tp.config.transformer
    batch = fake_batch(tp.config, B, seed=5)
    seg, ii, ei, img = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                           "extrinsics_inv", "image"))
    want_img, want = jax.jit(lambda p, s, i, e: jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0)))(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei))
    got_img, got = tp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0))
    assert got.shape == (B, 3, 4, 6) and got_img.shape == (B, 3, 32, 48, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)
    np.testing.assert_array_equal(
        tp.encode_images(img).numpy(),
        np.asarray(jp.encode_images(params, jnp.asarray(img))))


def _same_fields(port, ref, where=""):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{where}{f.name}.")
        else:
            assert a == b, f"{where}{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_presets_equal_the_reference(preset):
    """Every field the port's config has equals the JAX preset's (the
    argoverse_muse_rect preset among them)."""
    _same_fields(tcfg.PRESETS[preset](), jcfg.PRESETS[preset]())
    rect = tcfg.PRESETS["argoverse_muse_rect"]()
    assert rect.transformer.cam_latent_res == (16, 21)
    assert rect.transformer.num_img_tokens == 1008
    assert not rect.first_stage.geometric_embedding
