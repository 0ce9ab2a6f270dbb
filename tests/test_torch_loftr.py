"""The LoFTR matcher of the PyTorch port against the JAX package on the CPU,
at the outdoor widths on seeded weights (`init_random_params`, the same
numpy tree on both sides): the parameter tree leaf for leaf, the backbone's
coarse and fine maps (1e-4 of their max), the positional encoding (exact),
the coarse transformer (1e-5 of its max) and the dual-softmax confidence
(each package's on the same features against a float64 evaluation: the
port's within 1e-5 and no farther than twice the JAX package's), the
mutual-nearest matches (identical on one confidence matrix; on each side's
own matrix identical but at near-tie cells, of which there are none here),
the fine refinement (1e-4), the matcher on a padded 50-px strip
pair, and `convert_loftr_weights` on a synthetic checkpoint.
"""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.metrics import loftr as jl
from bevgen_torch.metrics import loftr as tl

TIE_TOL = 1e-4


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


@pytest.fixture(scope="module")
def params():
    return tl.init_random_params(np.random.default_rng(0))


@pytest.fixture(scope="module")
def model(params):
    return tl.LoFTR().load_params(params).eval()


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _pair(shape, seed):
    """A random image and a noisy copy: random weights match such pairs."""
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fine", [True, False])
def test_init_random_params_equal_the_jax_tree(fine):
    want = jl.init_random_params(np.random.default_rng(3), fine=fine)
    got = tl.init_random_params(np.random.default_rng(3), fine=fine)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the tree fills the module exactly (no key left over or missing)
    tl.LoFTR(fine=fine).load_params(got)


def test_backbone_matches_jax(params, model):
    x = np.random.default_rng(1).random((1, 64, 56, 1), dtype=np.float32)
    wc, wf = jl.backbone_fpn(_jparams(params), jnp.asarray(x))
    with torch.no_grad():
        tc, tf = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(tc.shape) == (1, 256, 8, 7)
    assert tuple(tf.shape) == (1, 128, 32, 28)
    assert _rel(tc.permute(0, 2, 3, 1), wc) <= 1e-4
    assert _rel(tf.permute(0, 2, 3, 1), wf) <= 1e-4


@pytest.mark.parametrize("hw", [(32, 7), (4, 6), (1, 1), (7, 32)])
def test_sine_position_encoding_is_exact(hw):
    np.testing.assert_array_equal(tl.sine_position_encoding(*hw),
                                  jl.sine_position_encoding(*hw))


def _coarse_inputs(seed, L0=(8, 7), L1=(8, 7)):
    rng = np.random.default_rng(seed)
    t0 = rng.standard_normal((1, L0[0] * L0[1], 256)).astype(np.float32)
    t1 = rng.standard_normal((1, L1[0] * L1[1], 256)).astype(np.float32)
    v0 = tl._coarse_valid((64, 50), (64, 56))
    v1 = tl._coarse_valid((64, 50), (64, 56))
    return t0, t1, v0, v1


def _confidence_f64(f0, f1, v0, v1):
    """The dual-softmax confidence in float64 numpy on fp32 features: the
    reference's formula (the JAX module's temperature), evaluated exactly
    enough that both packages' fp32 roundings show against it."""
    f0 = np.asarray(f0, np.float64)
    f1 = np.asarray(f1, np.float64)
    c = f0.shape[-1]
    sim = np.einsum("nlc,nsc->nls", f0 / c ** 0.5, f1 / c ** 0.5)
    sim = sim / jl.DS_TEMPERATURE
    sim = np.where(np.asarray(v0)[None, :, None], sim, -1e9)
    sim = np.where(np.asarray(v1)[None, None, :], sim, -1e9)

    def softmax(x, axis):
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)

    return softmax(sim, 1) * softmax(sim, 2)


# The confidence divides the features' product by the temperature 0.1 and
# goes through two softmaxes, so two fp32 evaluations of it differ by up to
# about 1e-5 on the same inputs, by the host's BLAS order alone. Each
# package's is held to a float64 evaluation on the same features instead:
# the port's within CONF_TOL of it and no farther than CONF_FACTOR times the
# JAX package's own distance.
CONF_TOL = 1e-5
CONF_FACTOR = 2.0


def test_coarse_transformer_and_confidence_match_jax(params, model):
    t0, t1, v0, v1 = _coarse_inputs(2)
    w0, w1 = jl.local_feature_transformer(_jparams(params), "loftr_coarse",
                                          jnp.asarray(t0), jnp.asarray(t1),
                                          jl.COARSE_LAYERS)
    with torch.no_grad():
        g0, g1 = model.loftr_coarse(torch.from_numpy(t0), torch.from_numpy(t1))
    assert _rel(g0, w0) <= 1e-5 and _rel(g1, w1) <= 1e-5
    # the confidence of both packages on the same features: the JAX
    # transformer's and the port's
    for f0, f1 in ((np.array(w0), np.array(w1)), (g0.numpy(), g1.numpy())):
        want = _confidence_f64(f0, f1, v0, v1)
        wconf = np.asarray(jl.coarse_match_confidence(
            jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(v0)[None],
            jnp.asarray(v1)[None]))
        with torch.no_grad():
            gconf = tl.coarse_match_confidence(
                torch.from_numpy(f0), torch.from_numpy(f1),
                torch.from_numpy(v0)[None], torch.from_numpy(v1)[None]).numpy()
        err_jax = float(np.abs(wconf - want).max())
        err_port = float(np.abs(gconf - want).max())
        assert err_port <= CONF_TOL, (err_port, err_jax)
        assert err_port <= CONF_FACTOR * err_jax, (err_port, err_jax)


def _match_set(idx0, idx1, valid):
    v = np.asarray(valid).astype(bool)
    return set(zip(np.asarray(idx0)[v].tolist(), np.asarray(idx1)[v].tolist()))


def test_mutual_nearest_matches_identical(params, model):
    """On one confidence matrix the two sets are identical, ties (exact
    equal maxima: the first column wins) included; on each package's own
    matrix they are identical but at near-tie cells, counted (none here)."""
    a, b = _pair((256, 50), 4)
    p0, hw0 = tl._pad_to_mult8(a)
    p1, hw1 = tl._pad_to_mult8(b)
    jp = _jparams(params)
    hc = (p0.shape[0] // 8, p0.shape[1] // 8)
    # each side's confidence matrix, as its matcher computes it
    c0, _ = jl.backbone_fpn(jp, jnp.asarray(p0)[None, :, :, None])
    c1, _ = jl.backbone_fpn(jp, jnp.asarray(p1)[None, :, :, None])
    pe = jnp.asarray(jl.sine_position_encoding(*hc))
    w0, w1 = jl.local_feature_transformer(
        jp, "loftr_coarse", (c0[0] + pe).reshape(1, -1, 256),
        (c1[0] + pe).reshape(1, -1, 256), jl.COARSE_LAYERS)
    v0 = jnp.asarray(jl._coarse_valid(hw0, p0.shape))[None]
    v1 = jnp.asarray(jl._coarse_valid(hw1, p1.shape))[None]
    wconf = np.array(jl.coarse_match_confidence(w0, w1, v0, v1)[0])
    with torch.no_grad():
        gc0, _ = model.backbone(torch.from_numpy(p0)[None, None])
        gc1, _ = model.backbone(torch.from_numpy(p1)[None, None])
        tpe = torch.from_numpy(tl.sine_position_encoding(*hc))
        g0, g1 = model.loftr_coarse(
            (gc0[0].permute(1, 2, 0) + tpe).reshape(1, -1, 256),
            (gc1[0].permute(1, 2, 0) + tpe).reshape(1, -1, 256))
        gconf = tl.coarse_match_confidence(
            g0, g1, torch.from_numpy(np.array(v0)),
            torch.from_numpy(np.array(v1)))[0]
    # one matrix, both functions; plus an exact tie in a row
    tied = wconf.copy()
    r, c = np.unravel_index(np.argmax(tied), tied.shape)
    tied[r, (c + 1) % tied.shape[1]] = tied[r, c]
    for conf in (wconf, tied):
        want = jl.mutual_nearest_matches(jnp.asarray(conf), hc, hc)
        got = tl.mutual_nearest_matches(torch.from_numpy(conf), hc, hc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each side's own matrix
    want = _match_set(*[np.asarray(t) for i, t in enumerate(
        jl.mutual_nearest_matches(jnp.asarray(wconf), hc, hc)) if i != 2])
    got_t = tl.mutual_nearest_matches(gconf, hc, hc)
    got = _match_set(got_t[0], got_t[1], got_t[3])
    near = tl.near_tie_cells(wconf, TIE_TOL)
    assert len(want) >= 8, "the pair should give matches"
    assert int(near.sum()) == 0
    assert got == want


def test_fine_refine_matches_jax(params, model):
    rng = np.random.default_rng(5)
    hc = (8, 7)
    L = hc[0] * hc[1]
    fine0 = rng.standard_normal((32, 28, 128)).astype(np.float32)
    fine1 = rng.standard_normal((32, 28, 128)).astype(np.float32)
    coarse0 = rng.standard_normal((L, 256)).astype(np.float32)
    coarse1 = rng.standard_normal((L, 256)).astype(np.float32)
    idx0 = np.arange(L)
    idx1 = rng.permutation(L)
    wdy, wdx = jl.fine_refine(_jparams(params), jnp.asarray(fine0),
                              jnp.asarray(fine1), jnp.asarray(idx0),
                              jnp.asarray(idx1), hc, hc,
                              coarse0=jnp.asarray(coarse0),
                              coarse1=jnp.asarray(coarse1))
    with torch.no_grad():
        gdy, gdx = model.fine_refine(
            torch.from_numpy(fine0).permute(2, 0, 1),
            torch.from_numpy(fine1).permute(2, 0, 1), torch.from_numpy(idx0),
            torch.from_numpy(idx1), torch.from_numpy(coarse0),
            torch.from_numpy(coarse1))
    assert float(np.abs(gdy.numpy() - np.asarray(wdy)).max()) <= 1e-4
    assert float(np.abs(gdx.numpy() - np.asarray(wdx)).max()) <= 1e-4


def test_matcher_on_a_padded_strip_pair(params):
    a, b = _pair((96, 50), 6)
    want = jl.LoFTRMatcher(params)(a, b)
    got = tl.LoFTRMatcher(params, device="cpu")(a, b)
    assert set(got) == set(want)
    assert len(want["confidence"]) > 0
    np.testing.assert_array_equal(got["keypoints0"], want["keypoints0"])
    np.testing.assert_allclose(got["keypoints1"], want["keypoints1"],
                               atol=1e-4)
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               rtol=1e-4)
    # every keypoint inside the real (unpadded) strip
    assert got["keypoints0"][:, 0].max() < 50
    assert got["keypoints0"][:, 1].max() < 96


def _torch_checkpoint(params):
    """`params` as a Lightning-style original checkpoint: torch layouts,
    the `matcher.` prefix, BatchNorm counters and a positional-encoding
    buffer, under `state_dict`."""
    sd = {}
    for k, v in params.items():
        a = v.transpose(3, 2, 0, 1) if v.ndim == 4 else (
            v.T if v.ndim == 2 and k.endswith(".weight") else v)
        sd[f"matcher.{k}"] = torch.from_numpy(np.ascontiguousarray(a))
        if k.endswith("running_var"):
            sd[f"matcher.{k[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(7)
    sd["matcher.pos_encoding.pe"] = torch.zeros(1, 256, 8, 8)
    return {"state_dict": sd, "epoch": 3}


def test_convert_loftr_weights_writes_the_jax_npz(params, model, tmp_path):
    ckpt = tmp_path / "loftr.ckpt"
    torch.save(_torch_checkpoint(params), ckpt)
    outs = {}
    for name, mod in (("jax", jl), ("port", tl)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.convert_loftr_weights(str(ckpt), str(tmp_path / f"{name}.npz"))
        outs[name] = buf.getvalue()
    assert outs["port"] == outs["jax"] and "skipped 1" in outs["jax"]
    with np.load(tmp_path / "jax.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the checkpoint loads as it is, the same state as the npz route
    direct = tl.LoFTR().load_torch_state_dict(torch.load(ckpt)["state_dict"])
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(direct.state_dict()[k], v), k
    # a checkpoint without LoFTR's keys fails on both sides alike
    torch.save({"state_dict": {"other.weight": torch.zeros(2, 2)}},
               tmp_path / "bad.ckpt")
    for mod in (jl, tl):
        with pytest.raises(ValueError, match="lacks expected LoFTR keys"):
            mod.convert_loftr_weights(str(tmp_path / "bad.ckpt"),
                                      str(tmp_path / "bad.npz"))
