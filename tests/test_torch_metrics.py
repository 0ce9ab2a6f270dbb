"""The evaluation path of the PyTorch port against the JAX package on the
CPU, on the same seeded numpy inputs and weights: the Frechet statistics
(1e-10 relative), InceptionV3 pool3 features at 299x299, 256x256 and the
shrinking 256x336 and 224x400 (b=2, 1e-4 of max |f|), the Inception
converter (the same npz, key for key and leaf for leaf; pytorch-fid's state
dict loaded directly gives the same parameters), the consistency ratio with
LoFTR (confidences 1e-4 relative, MAGSAC inliers equal) and with SIFT
(identical), and the `metrics_eval` CLI over the sample/ sample_gt/ tree
and the flat nuScenes tree with every weight file and without any (the
same keys; values 1e-4 relative, compared before the CLIs' 4-decimal
rounding), and its sha1 check.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.metrics import consistency as jcons
from bevgen_tpu.metrics import fid as jfid
from bevgen_tpu.metrics import inception as jinc
from bevgen_tpu.models import lpips as jlpips
from bevgen_tpu.scripts import metrics_eval as jeval
from bevgen_torch.metrics import consistency as tcons
from bevgen_torch.metrics import fid as tfid
from bevgen_torch.metrics import inception as tinc
from bevgen_torch.metrics import loftr as tloftr
from bevgen_torch.scripts import metrics_eval as teval
from torch_parity import random_tree

ARGO_CAMS = ("ring_front_left", "ring_front_center", "ring_front_right")
NUSC_CAMS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT")


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
def weights(tmp_path_factory):
    """Seeded weight files: pytorch-fid's layout (.pth) with both packages'
    converted Inception npz, an LPIPS npz, a LoFTR npz."""
    d = tmp_path_factory.mktemp("weights")
    sd = tinc.random_fid_state_dict(0)
    torch.save(sd, d / "pt_inception.pth")
    tinc.convert_inception_weights(str(d / "pt_inception.pth"),
                                   str(d / "inception_port.npz"))
    jinc.convert_inception_weights(str(d / "pt_inception.pth"),
                                   str(d / "inception.npz"))
    x = jnp.zeros((1, 32, 32, 3))
    tree = random_tree(jax.eval_shape(jlpips.LPIPS().init,
                                      jax.random.PRNGKey(0), x, x), 5)
    np.savez(d / "lpips.npz", **{
        "/".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(tree["params"])})
    # (random LoFTR weights match noisy copies under some seeds only: seed
    # 0's do, so that matches and MAGSAC inliers take part)
    np.savez(d / "loftr.npz", **tloftr.init_random_params(
        np.random.default_rng(0)))
    return {"state_dict": sd, "dir": d, "inception": str(d / "inception.npz"),
            "lpips": str(d / "lpips.npz"), "loftr": str(d / "loftr.npz")}


def test_frechet_statistics_equal_the_jax_functions():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 16)).astype(np.float32)
    b = (0.7 * rng.standard_normal((30, 16)) + 0.2).astype(np.float32)
    ja, ta = jfid.FeatureStats(16), tfid.FeatureStats(16)
    for s in (ja, ta):
        s.update(a[:25]); s.update(a[25:])
    for x, y in zip(ta.finalize(), ja.finalize()):
        np.testing.assert_allclose(x, y, rtol=1e-10)
    jb, tb = jfid.FeatureStats(16), tfid.FeatureStats(16)
    jb.update(b); tb.update(b)
    want = jfid.frechet_distance(*ja.finalize(), *jb.finalize())
    assert tfid.frechet_distance(*ta.finalize(), *tb.finalize()) == \
        pytest.approx(want, rel=1e-10)
    assert tfid.fid_from_features(a, b) == pytest.approx(
        jfid.fid_from_features(a, b), rel=1e-10)
    np.testing.assert_allclose(tfid._sqrtm_product(ta.finalize()[1],
                                                   tb.finalize()[1]),
                               jfid._sqrtm_product(ja.finalize()[1],
                                                   jb.finalize()[1]),
                               rtol=1e-10, atol=1e-12)


def test_convert_inception_weights_writes_the_jax_npz(weights):
    d = weights["dir"]
    with np.load(d / "inception.npz") as want, \
            np.load(d / "inception_port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert not any(k.startswith("fc") for k in got.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # pytorch-fid's state dict, loaded directly: the same parameters
    from_npz = tinc.load_inception(str(d / "inception_port.npz"))
    direct = tinc.InceptionV3().load_pytorch_fid(weights["state_dict"])
    for (n, p), (_, q) in zip(from_npz.named_parameters(),
                              direct.named_parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(KeyError, match="unset"):
        tinc.InceptionV3().load_pytorch_fid(
            {k: v for k, v in weights["state_dict"].items()
             if not k.startswith("Mixed_7c.branch_pool")})


@pytest.fixture(scope="module")
def inception_pair(weights):
    model = jinc.InceptionV3()
    params = jinc.load_params(weights["inception"])
    return (jax.jit(lambda x: model.apply(params, x)),
            tinc.load_inception(weights["inception"]))


@pytest.mark.parametrize("hw", [(299, 299), (256, 256), (256, 336),
                                (224, 400)])
def test_inception_features_match_jax(inception_pair, hw):
    japply, model = inception_pair
    x = np.random.default_rng(hw[1]).uniform(0, 1, (2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(japply(jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_make_inception_features_matches_jax(weights):
    assert tfid.make_inception_features("missing.npz", device="cpu") is None
    assert jfid.make_inception_features("missing.npz") is None
    x = np.random.default_rng(7).uniform(0, 1, (4, 64, 48, 3)).astype(
        np.float32)
    got = tfid.make_inception_features(weights["inception"], batch_size=2,
                                       device="cpu")(x)
    want = jfid.make_inception_features(weights["inception"],
                                        batch_size=2)(x)
    assert got.dtype == np.float32 and got.shape == (4, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _scene(rng, h, w, noise):
    """Three cameras whose adjacent 50-px edges show the same content
    (with noise), so that the overlap strips match. Gray pixel noise, in
    all three channels: the seeded LoFTR weights match such strips."""
    def gray(shape):
        return np.repeat(rng.random((*shape, 1), dtype=np.float32), 3, -1)
    imgs = [gray((h, w))]
    for _ in range(2):
        nxt = gray((h, w))
        nxt[:, :50] = np.clip(imgs[-1][:, -50:] + noise * gray((h, 50)) -
                              noise / 2, 0, 1)
        imgs.append(nxt)
    return imgs


def _scene_pair(seed, cams, h=256, w=128):
    rng = np.random.default_rng(seed)
    gen = dict(zip(cams, _scene(rng, h, w, 0.1)))
    gt = dict(zip(cams, _scene(rng, h, w, 0.05)))
    return gen, gt


def test_consistency_ratio_with_loftr_matches_jax(weights, monkeypatch):
    monkeypatch.setenv("BEVGEN_LOFTR_WEIGHTS", weights["loftr"])
    monkeypatch.setattr(jcons, "_LOFTR_MATCHER", None)
    matcher = tcons.get_matcher("cpu")
    assert isinstance(matcher, tloftr.LoFTRMatcher)
    assert tcons.get_matcher("cpu") is matcher          # cached
    gen, gt = _scene_pair(0, ARGO_CAMS)
    want = jcons.consistency_ratio(gen, gt, jcons.ARGOVERSE_PAIRS)
    got = tcons.consistency_ratio(gen, gt, tcons.ARGOVERSE_PAIRS, matcher)
    assert set(got) == set(want)
    assert want["gt_inliers"] > 0 and want["gen_inliers"] > 0
    for k in ("gen_confidence", "gt_confidence", "ratio"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k in ("gen_inliers", "gt_inliers"):
        assert got[k] == want[k], k
    # one strip pair: the match counts and keypoints agree too
    a, b = tcons.edge_windows(gt["ring_front_left"], gt["ring_front_center"])
    jm = jcons.match_strips(a, b)
    tm = tcons.match_strips(a, b, matcher=matcher)
    assert tm["num_matches"] == jm["num_matches"] >= 8
    assert tm["inliers"] == jm["inliers"]


def test_consistency_sift_route_is_identical(monkeypatch):
    monkeypatch.delenv("BEVGEN_LOFTR_WEIGHTS", raising=False)
    monkeypatch.setattr(jcons, "_LOFTR_MATCHER", None)
    assert tcons.get_matcher() is None        # no weights: no device needed
    for cams, pairs in ((ARGO_CAMS, tcons.ARGOVERSE_PAIRS),
                        (NUSC_CAMS, tcons.NUSCENES_PAIRS)):
        gen, gt = _scene_pair(1, cams)
        want = jcons.consistency_ratio(gen, gt, pairs)
        assert want["gt_confidence"] > 0
        assert tcons.consistency_ratio(gen, gt, pairs) == want
        a, b = tcons.edge_windows(gen[cams[0]], gen[cams[1]])
        assert tcons.match_strips_sift(a, b) == jcons.match_strips_sift(a, b)


def _write_tree(root, layout, seed=3, tokens=("tokA", "tokB")):
    import cv2
    cams = ARGO_CAMS if layout == "sample" else NUSC_CAMS
    for i, tok in enumerate(tokens):
        gen, gt = _scene_pair(seed + i, cams, h=128, w=96)
        for tree, imgs in (("gen", gen), ("gt", gt)):
            for cam, img in imgs.items():
                bgr = (img[..., ::-1] * 255).astype(np.uint8)
                if layout == "sample":
                    sub = "sample" if tree == "gen" else "sample_gt"
                    d = root / sub / tok
                    name = f"{cam}.jpg"
                else:
                    d = root / tree
                    name = f"{tok}_{cam}.jpg"
                d.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(d / name), bgr)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("layout", ["sample", "nuscenes"])
@pytest.mark.parametrize("with_weights", [True, False])
def test_metrics_eval_cli_matches_jax(weights, tmp_path, monkeypatch, capsys,
                                      layout, with_weights):
    _write_tree(tmp_path, layout)
    monkeypatch.setattr(jcons, "_LOFTR_MATCHER", None)
    args = [f"dir={tmp_path}", "consistency=true", "per_camera=true"]
    if with_weights:
        monkeypatch.setenv("BEVGEN_LOFTR_WEIGHTS", weights["loftr"])
        args += [f"inception_weights={weights['inception']}",
                 f"lpips_weights={weights['lpips']}"]
    else:
        monkeypatch.delenv("BEVGEN_LOFTR_WEIGHTS", raising=False)
        args += [f"inception_weights={tmp_path / 'none.npz'}",
                 f"lpips_weights={tmp_path / 'none.npz'}"]
    rounded = None
    if not with_weights:  # the printed line, rounded (the cheap case)
        teval.main(args + ["device=cpu"])
        rounded = _last_json(capsys)
    # the values before the 4-decimal rounding, on both sides
    for mod in (jeval, teval):
        monkeypatch.setattr(mod, "round", lambda v, n: v, raising=False)
    jeval.main(args)
    want = _last_json(capsys)
    teval.main(args + ["device=cpu"])
    got = _last_json(capsys)
    assert list(got) == list(want)
    cams = ARGO_CAMS if layout == "sample" else NUSC_CAMS
    fid_key = ("fid_inception" if with_weights
               else "fid_pixelstats(NOT paper FID)")
    assert list(want) == ["psnr", "ssim", "lpips", fid_key,
                          *(f"fid/{c}" for c in sorted(cams)),
                          "consistency_gen_conf", "consistency_gt_conf"]
    assert (want["lpips"] is None) is not with_weights
    assert want["consistency_gt_conf"] > 0
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-4), k
    if rounded is not None:
        assert rounded == {k: v if v is None else round(v, 4)
                           for k, v in got.items()}


def test_metrics_eval_sha1_mismatch_exits_as_the_jax_cli(tmp_path):
    import cv2
    _write_tree(tmp_path, "nuscenes", tokens=("tokA",))
    h = teval.verify_tree_hashes(tmp_path, ["gen", "gt"])
    assert h == jeval.verify_tree_hashes(tmp_path, ["gen", "gt"])
    cv2.imwrite(str(tmp_path / "gen" / "tokC_CAM_FRONT.jpg"),
                np.zeros((128, 96, 3), np.uint8))
    msgs = []
    for mod, extra in ((jeval, []), (teval, ["device=cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.main([f"dir={tmp_path}", *extra])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "sample trees differ" in msgs[0]
    # strict=false pairs the intersection on both sides
    for mod in (jeval, teval):
        gen, gt, scenes = mod.load_pairs(tmp_path, strict=False)
        assert len(gen) == len(gt) == 3 and len(scenes) == 1
    with pytest.raises(SystemExit, match="unknown argument"):
        teval.main([f"dir={tmp_path}", "device=cpu", "strict=false",
                    "bogus=1"])
