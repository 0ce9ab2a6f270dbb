"""The port's host-side scripts and auxiliaries against the JAX package on
the CPU, on the same inputs: `scripts/preprocess.py` on
`tests/test_utils_metrics.py`'s synthetic AV2 log (the npz rasters equal
exactly, on the cv2 and the native route); `scripts/curate.py` (the
interesting and different token lists equal, the filter keeps and removes
the same samples); `scripts/make_figures.py` in its three modes (figure
PNGs and video frames pixel for pixel, the site's HTML text); `scripts/
pseudo_seg.py` with a scripted TorchScript model (`tests/
test_pseudo_seg.py`'s three cases; the class maps equal exactly);
`models/conditioning.py` (int32, equal values); `utils/logging.py`
(`MetricsLogger`'s records and `save_mask_plots`' PNGs equal); and
`models/masks.py:dense_attention_mask` (exactly).
"""
import json

import numpy as np
import pytest
import torch

from bevgen_torch.scripts import curate as tcurate
from bevgen_torch.scripts import make_figures as tfig
from bevgen_torch.scripts import preprocess as tpre
from bevgen_torch.scripts import pseudo_seg as tseg
from bevgen_tpu.scripts import curate as jcurate
from bevgen_tpu.scripts import make_figures as jfig
from bevgen_tpu.scripts import preprocess as jpre
from bevgen_tpu.scripts import pseudo_seg as jseg


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


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---- preprocess ---------------------------------------------------------------

def _write_av2_log(root, ts=1000, yaw=0.0):
    """tests/test_utils_metrics.py's synthetic AV2 log (plus a turned ego
    pose and a second, crossing lane), under root/val/LOG1."""
    import pandas as pd
    log = root / "val" / "LOG1"
    (log / "sensors" / "lidar").mkdir(parents=True)
    (log / "map").mkdir(parents=True)
    (log / "sensors" / "lidar" / f"{ts}.feather").touch()
    (log / "sensors" / "lidar" / f"{ts + 1}.feather").touch()  # no pose: skipped
    qw, qz = np.cos(yaw / 2), np.sin(yaw / 2)
    pd.DataFrame([{"timestamp_ns": ts, "qw": qw, "qx": 0, "qy": 0,
                   "qz": qz, "tx_m": 100.0, "ty_m": 200.0, "tz_m": 0.0}]
                 ).to_feather(log / "city_SE3_egovehicle.feather")
    pd.DataFrame([{"timestamp_ns": ts, "category": c,
                   "length_m": l, "width_m": w, "height_m": 1.6,
                   "qw": 1.0, "qx": 0, "qy": 0, "qz": 0,
                   "tx_m": x, "ty_m": y, "tz_m": 0.0}
                  for c, l, w, x, y in (("REGULAR_VEHICLE", 4.0, 2.0, 10.0, 0),
                                        ("PEDESTRIAN", 0.8, 0.8, 5.0, 3.0),
                                        ("BUS", 11.0, 2.6, -12.0, -4.0))]
                 ).to_feather(log / "annotations.feather")
    amap = {
        "drivable_areas": {"1": {"area_boundary": [
            {"x": 80, "y": 180, "z": 0}, {"x": 80, "y": 220, "z": 0},
            {"x": 120, "y": 220, "z": 0}, {"x": 120, "y": 180, "z": 0}]}},
        "lane_segments": {"2": {
            "left_lane_boundary": [{"x": 90, "y": 195, "z": 0},
                                   {"x": 115, "y": 195, "z": 0}],
            "right_lane_boundary": [{"x": 90, "y": 205, "z": 0},
                                    {"x": 115, "y": 205, "z": 0}],
            "is_intersection": True},
            "3": {"left_lane_boundary": [{"x": 100, "y": 100},
                                         {"x": 101, "y": 300}],
                  "right_lane_boundary": [{"x": 104, "y": 100},
                                          {"x": 105, "y": 300}],
                  "is_intersection": False}},
        "pedestrian_crossings": {"4": {
            "edge1": [{"x": 95, "y": 190, "z": 0}, {"x": 95, "y": 198}],
            "edge2": [{"x": 97, "y": 190, "z": 0}, {"x": 97, "y": 198}]}},
    }
    with open(log / "map" / "log_map_archive_LOG1.json", "w") as f:
        json.dump(amap, f)
    return log


@pytest.mark.parametrize("route", ["cv2", "native"])
def test_preprocess_rasters_equal_jax(tmp_path, monkeypatch, route):
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER",
                       "1" if route == "native" else "0")
    log = _write_av2_log(tmp_path / "straight")
    _write_av2_log(tmp_path / "turned", yaw=0.4)
    assert tpre.process_log(log, tmp_path / "port", "val") == 1
    assert jpre.process_log(log, tmp_path / "jax", "val") == 1
    name = "val/LOG1/1000.npz"
    got, want = _npz(tmp_path / "port" / name), _npz(tmp_path / "jax" / name)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    layers = next(iter(got.values()))
    assert layers.shape == (256, 256, 7)
    assert layers[..., 0].sum() > 0 and layers[..., 2].sum() > 0
    assert layers[..., 1].sum() > 0 and layers[..., 4].sum() > 1000
    assert layers[..., 5].sum() > 0 and layers[..., 6].sum() > 0
    assert np.nonzero(layers[..., 0])[0].max() < 128  # ahead: top half
    # an existing raster is kept unless overwrite; main over the split
    assert tpre.process_log(log, tmp_path / "port", "val") == 0
    tpre.main([f"dataset_dir={tmp_path / 'turned'}",
               f"save_dir={tmp_path / 'port_t'}", "split=val"])
    jpre.main([f"dataset_dir={tmp_path / 'turned'}",
               f"save_dir={tmp_path / 'jax_t'}", "split=val"])
    got, want = _npz(tmp_path / "port_t" / name), _npz(tmp_path / "jax_t" / name)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(SystemExit, match="unknown"):
        tpre.main([f"dataset_dir={tmp_path}", f"save_dir={tmp_path}",
                   "bogus=1"])


def test_preprocess_helpers_equal_jax(tmp_path):
    log = _write_av2_log(tmp_path)
    tposes, jposes = tpre.load_poses(log), jpre.load_poses(log)
    for a, b in zip(tpre.pose_at(tposes, 1000), jpre.pose_at(jposes, 1000)):
        np.testing.assert_array_equal(a, b)
    import pandas as pd
    for _, row in pd.read_feather(log / "annotations.feather").iterrows():
        np.testing.assert_array_equal(tpre.cuboid_footprint(row),
                                      jpre.cuboid_footprint(row))
    assert tpre.load_map_archive(log) == jpre.load_map_archive(log)
    assert tpre.load_map_archive(tmp_path) == {}
    pts = [{"x": 1.5, "y": 2}, {"x": 3, "y": 4, "z": 5}]
    np.testing.assert_array_equal(tpre.polyline_points(pts),
                                  jpre.polyline_points(pts))


# ---- curate -------------------------------------------------------------------

def _bev_tree(root):
    from bevgen_torch.data.rasterize import save_bev_raster
    d = root / "bev" / "log1"
    d.mkdir(parents=True)
    busy = np.zeros((256, 256, 7), np.float32)
    busy[100:130, 100:130, 0] = 1
    busy[50:60, 50:60, 2] = 1
    a = np.zeros((256, 256, 7), np.float32)
    a[:64, :64, 0] = 1
    c = np.zeros((256, 256, 7), np.float32)
    c[128:, 128:, 4] = 1
    for name, arr in (("111", busy), ("222", np.zeros_like(a)), ("1", a),
                      ("2", a), ("3", c)):
        save_bev_raster(d / f"{name}.npz", arr)
    return root / "bev"


def _filter_tree(root):
    """tests/test_aux.py's filter tree: one good sample, one noisy."""
    import cv2
    rng = np.random.default_rng(0)
    for tok, noise in (("good", 0.0), ("bad", 1.0), ("mid", 0.3)):
        for sub in ("sample", "sample_gt", "viz"):
            (root / sub / tok).mkdir(parents=True)
        base = (rng.uniform(0, 255, (32, 32, 3))).astype(np.uint8)
        noisy = np.clip(base + noise * rng.normal(0, 120, base.shape),
                        0, 255).astype(np.uint8)
        cv2.imwrite(str(root / "sample" / tok / "cam.jpg"), noisy)
        cv2.imwrite(str(root / "sample_gt" / tok / "cam.jpg"), base)


def test_curate_equals_jax(tmp_path):
    bev = _bev_tree(tmp_path)
    got = tcurate.interesting_scores(bev)
    assert got == jcurate.interesting_scores(bev)
    assert got[0][0] == "log1_1"   # 64x64 vehicle pixels lead
    assert tcurate.interesting_scores(bev, max_samples=2) == \
        jcurate.interesting_scores(bev, max_samples=2)
    for top in (2, 3, 9):
        toks = tcurate.different_scores(bev, top=top)
        assert toks == jcurate.different_scores(bev, top=top)
    assert tcurate.different_scores(tmp_path / "none", top=2) == []

    for side in ("port", "jax"):
        _filter_tree(tmp_path / side)
    for keep in (0.5,):
        got = tcurate.filter_outputs(tmp_path / "port", keep_frac=keep)
        want = jcurate.filter_outputs(tmp_path / "jax", keep_frac=keep)
        assert got == want == (1, 2)
    for side in ("port", "jax"):
        assert sorted(p.name for p in (tmp_path / side / "sample").iterdir()) \
            == ["good"]
        assert not (tmp_path / side / "viz" / "bad").exists()

    tcurate.main(["mode=interesting", f"bev_dir={bev}", "top=2",
                  f"out={tmp_path / 'i.txt'}"])
    jcurate.main(["mode=interesting", f"bev_dir={bev}", "top=2",
                  f"out={tmp_path / 'ji.txt'}"])
    assert (tmp_path / "i.txt").read_text() == (tmp_path / "ji.txt").read_text()
    tcurate.main(["mode=different", f"bev_dir={bev}", "top=3",
                  f"out={tmp_path / 'd.txt'}"])
    jcurate.main(["mode=different", f"bev_dir={bev}", "top=3",
                  f"out={tmp_path / 'jd.txt'}"])
    assert (tmp_path / "d.txt").read_text() == (tmp_path / "jd.txt").read_text()
    with pytest.raises(SystemExit, match="unknown mode"):
        tcurate.main(["mode=bogus"])
    with pytest.raises(SystemExit, match="unknown"):
        tcurate.main(["mode=interesting", f"bev_dir={bev}", "bogus=1"])


# ---- make_figures -------------------------------------------------------------

@pytest.fixture()
def output_tree(tmp_path):
    """tests/test_figures.py's tree, plus a bev.png and a sample whose GT
    lacks a camera."""
    from PIL import Image
    rng = np.random.default_rng(0)
    root = tmp_path / "tree"
    for tok in ("scene_a", "scene_b", "scene_c"):
        for sub in ("sample", "sample_gt"):
            d = root / sub / tok
            d.mkdir(parents=True)
            for cam in ("cam0", "cam1"):
                if tok == "scene_c" and sub == "sample_gt" and cam == "cam1":
                    continue
                Image.fromarray(rng.integers(0, 255, (32, 48, 3), np.uint8)
                                ).save(d / f"{cam}.jpg")
            np.savez_compressed(d / "bev.npz", rng.uniform(0, 1, (16, 16, 7)))
    Image.fromarray(rng.integers(0, 255, (20, 20, 3), np.uint8)).save(
        root / "sample" / "scene_a" / "bev.png")
    return root


def _png_pixels(d):
    from PIL import Image
    return {p.name: np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))}


def _video_frames(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def test_make_figures_modes_equal_jax(output_tree, tmp_path):
    for mode in ("figures", "site", "video"):
        outs = {}
        for side, mod in (("port", tfig), ("jax", jfig)):
            out = tmp_path / f"{side}_{mode}"
            mod.main([f"dir={output_tree}", f"mode={mode}", f"out={out}",
                      "fps=2"])
            outs[side] = out
        port, jax_ = outs["port"], outs["jax"]
        if mode == "figures":
            got, want = _png_pixels(port), _png_pixels(jax_)
            assert list(got) == ["scene_a.png", "scene_b.png", "scene_c.png"]
        elif mode == "site":
            got, want = (_png_pixels(port / "figures"),
                         _png_pixels(jax_ / "figures"))
            html = (port / "index.html").read_text()
            assert "scene_a" in html and "scene_b" in html
            assert html.replace("bevgen_torch", "bevgen_tpu") == \
                (jax_ / "index.html").read_text()
        else:
            got = dict(enumerate(_video_frames(port / "samples.mp4")))
            want = dict(enumerate(_video_frames(jax_ / "samples.mp4")))
            assert len(got) == 3
            assert _png_pixels(port / "frames").keys() == \
                _png_pixels(jax_ / "frames").keys()
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    # max_samples, and an unknown mode
    assert tfig.make_figures(output_tree, tmp_path / "one", max_samples=1) == \
        jfig.make_figures(output_tree, tmp_path / "jone", max_samples=1) == 1
    with pytest.raises(SystemExit, match="unknown mode"):
        tfig.main([f"dir={output_tree}", "mode=bogus"])


# ---- pseudo_seg ---------------------------------------------------------------

class TinySeg(torch.nn.Module):
    def __init__(self, n_classes=5):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(3, n_classes, 1)

    def forward(self, x):
        return self.conv(x)


def _images(root, names, shape, seed=0):
    from PIL import Image
    for i, name in enumerate(names):
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.random.default_rng(seed + i).integers(
            0, 255, shape, np.uint8)).save(p)


def _seg_outputs(d):
    return {str(p.relative_to(d)): np.load(p)["pred"]
            for p in sorted(d.rglob("*.npz"))}


@pytest.fixture(scope="module")
def seg_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("seg") / "seg.pt"
    torch.jit.script(TinySeg()).save(str(path))
    return path


def test_pseudo_seg_writes_the_jax_npz_mirror(tmp_path, seg_model):
    root = tmp_path / "images"
    _images(root, ("log_a/CAM_FRONT/1.jpg", "log_a/CAM_BACK/2.jpg",
                   "log_b/CAM_FRONT/3.jpg"), (64, 96, 3))
    args = [f"image_root={root}", f"model_path={seg_model}", "size=48,24",
            "batch_size=2"]
    tseg.main(args + [f"save_dir={tmp_path / 'port'}", "device=cpu"])
    jseg.main(args + [f"save_dir={tmp_path / 'jax'}"])
    got, want = _seg_outputs(tmp_path / "port"), _seg_outputs(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 3
    for k in got:
        assert got[k].shape == (24, 48) and got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[k])
    assert max(int(p.max()) for p in got.values()) < 5


def test_pseudo_seg_sharding_equals_jax(tmp_path, seg_model):
    root = tmp_path / "images"
    _images(root, [f"log/cam/{i}.jpg" for i in range(4)], (8, 8, 3))
    args = [f"image_root={root}", f"model_path={seg_model}", "size=8,8",
            "shard=1", "num_shards=2"]
    tseg.main(args + [f"save_dir={tmp_path / 'port'}", "platform=cpu"])
    jseg.main(args + [f"save_dir={tmp_path / 'jax'}"])
    got, want = _seg_outputs(tmp_path / "port"), _seg_outputs(tmp_path / "jax")
    assert list(got) == list(want) == ["log/cam/1.npz", "log/cam/3.npz"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_pseudo_seg_requires_model(tmp_path):
    with pytest.raises(SystemExit, match="model_path"):
        tseg.main([f"image_root={tmp_path}", f"save_dir={tmp_path}"])
    with pytest.raises(SystemExit, match="model_path"):
        jseg.main([f"image_root={tmp_path}", f"save_dir={tmp_path}"])
    with pytest.raises(SystemExit, match="unknown"):
        tseg.main([f"image_root={tmp_path}", f"save_dir={tmp_path}",
                   "model_path=x", "bogus=1"])


# ---- conditioning, logging, masks ---------------------------------------------

def test_conditioning_providers_equal_jax():
    import jax.numpy as jnp
    from bevgen_torch.models.conditioning import Labelator, SOSProvider
    from bevgen_tpu.models import conditioning as jcond
    labels = np.array([3, 0, 7])
    c, none, idx = Labelator(n_classes=10).encode(labels)
    jc, _, jidx = jcond.Labelator(n_classes=10).encode(labels)
    assert none is None and c.dtype == idx.dtype == torch.int32
    assert c.shape == (3, 1)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    c = Labelator(10, quantize_interface=False).encode(torch.tensor([[2, 5]]))
    np.testing.assert_array_equal(c.numpy(), np.asarray(
        jcond.Labelator(10, quantize_interface=False).encode(
            jnp.asarray([[2, 5]]))))
    for x in (np.zeros((4, 5), np.float32), torch.zeros(4, 8)):
        c, _, idx = SOSProvider(sos_token=11).encode(x)
        jc, _, jidx = jcond.SOSProvider(sos_token=11).encode(np.asarray(x))
        assert c.dtype == torch.int32 and c.shape == (4, 1)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    c = SOSProvider(5, quantize_interface=False).encode(torch.zeros(2, 3))
    assert c.tolist() == [[5], [5]]


def test_metrics_logger_records_equal_jax(tmp_path):
    from bevgen_torch.utils.logging import MetricsLogger
    from bevgen_tpu.utils.logging import MetricsLogger as JaxLogger
    recs = {}
    for side, cls in (("port", MetricsLogger), ("jax", JaxLogger)):
        d = tmp_path / side
        lg = cls(d, use_wandb=False, config={"a": 1, "b": "x"})
        lg.log(1, {"loss": 0.5, "n": 3})
        lg.log(2, {"loss": np.float32(0.25), "v": np.arange(3.0),
                   "s": np.array(1.5), "name": "ok"})
        lg.log_image("grid", np.arange(48, dtype=np.uint8).reshape(4, 4, 3),
                     step=1)
        lg.close()
        lines = (d / "metrics.jsonl").read_text().strip().splitlines()
        recs[side] = [{k: v for k, v in json.loads(l).items() if k != "time"}
                      for l in lines]
        assert json.loads((d / "config.json").read_text()) == {"a": 1,
                                                               "b": "x"}
    assert recs["port"] == recs["jax"]
    assert recs["port"][0] == {"step": 1, "loss": 0.5, "n": 3.0}
    from PIL import Image
    got = np.asarray(Image.open(tmp_path / "port" / "images" /
                                "grid_000001.png"))
    want = np.asarray(Image.open(tmp_path / "jax" / "images" /
                                 "grid_000001.png"))
    np.testing.assert_array_equal(got, want)
    # torch tensors (the port's metrics) log as their values
    lg = MetricsLogger(tmp_path / "t", use_wandb=False)
    lg.log(3, {"loss": torch.tensor(0.125), "v": torch.tensor([1.0, 2.0])})
    lg.close()
    rec = json.loads((tmp_path / "t" / "metrics.jsonl").read_text())
    assert rec["loss"] == 0.125 and rec["v"] == [1.0, 2.0]


def _mask_configs():
    from bevgen_torch.core.config import MultiViewConfig as TCfg
    from bevgen_tpu.core.config import MultiViewConfig as JCfg
    kw = dict(num_layers=1, num_heads=2, num_embed=32, hidden_size=32,
              vocab_size=16, cond_vocab_size=16, num_cams=3,
              cam_names="ARGOVERSE_FRONT_CAMERAS", dataset="argoverse",
              cam_latent_res=(4, 4), bev_latent_res=(4, 4),
              sparse_block_size=8, density=0.5, window_len=4)
    yield TCfg(**kw), JCfg(**kw)
    kw.update(camera_bias=False, num_heads=4, density=0.7)
    yield TCfg(**kw), JCfg(**kw)


def test_save_mask_plots_equal_jax(tmp_path):
    from bevgen_torch.utils.logging import save_mask_plots
    from bevgen_tpu.utils.logging import save_mask_plots as jax_plots
    for i, (tc, jc) in enumerate(_mask_configs()):
        out = save_mask_plots(tc, tmp_path / f"port{i}")
        jout = jax_plots(jc, tmp_path / f"jax{i}")
        got, want = _png_pixels(out), _png_pixels(jout)
        assert {"allowed_pattern.png", "static_layout.png"} <= set(got)
        assert ("camera_bias_prob_matrix.png" in got) == (i == 0)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dense_attention_mask_equals_jax():
    from bevgen_torch.core import config as tcfg
    from bevgen_torch.models.masks import dense_attention_mask
    from bevgen_tpu.core import config as jcfg
    from bevgen_tpu.models.masks import dense_attention_mask as jax_mask
    cases = list(_mask_configs()) + [
        (tcfg.tiny_test_config().transformer,
         jcfg.tiny_test_config().transformer)]
    for tc, jc in cases:
        got = dense_attention_mask(tc)
        assert got.dtype == np.float32 and got.shape[0] == got.shape[1]
        np.testing.assert_array_equal(got, jax_mask(jc))
