"""The data path of the PyTorch port against the JAX package, on the CPU:
its own copies of the data modules, the sample writer, tokenization and the
generate CLI's real-data path.

One synthetic AV2 tree (the JAX tests' recipe, `tests/test_augmentation.py`:
one log, three front cameras, 20 Hz cameras and 10 Hz lidar, calibration
feathers, BEV npz rasters) is read by both packages' `ArgoverseDataset`:
samples equal key for key (arrays bit for bit) in multi-camera,
single-camera, rect (`square_image=False`) and augmented mode with a fixed
seed, under `eval_generate` resume, `mini_dataset` and `specific_frames`.
Both loaders give the same batch order under shuffle; raster files, sync
tables and camera-geometry outputs are bit-equal; the two
`GenerationWriter`s write the same tree (npz members byte for byte, JPEG and
PNG files of equal names and sizes); `tokenize_dataset` shards are equal and
train through `train_stage2 tokens_dir=`; the generate CLI on the tree
writes the reference's tree, resumes, and exits on a camera-count mismatch
and on `mini_dataset=false`; `config=<yaml> modes=[argoverse,generate]`.
"""
import dataclasses
import json
import os
import pickle
import random
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from bevgen_tpu.data import camera_geometry as jcg
from bevgen_tpu.data import datamodule as jdm
from bevgen_tpu.data import rasterize as jras
from bevgen_tpu.data import sync as jsync
from bevgen_tpu.data.argoverse import ArgoverseDataset as JaxDataset
from bevgen_torch.data import camera_geometry as tcg
from bevgen_torch.data import datamodule as tdm
from bevgen_torch.data import rasterize as tras
from bevgen_torch.data import sync as tsync
from bevgen_torch.data.argoverse import ArgoverseDataset
from torch_parity import tiny_pipelines

cv2 = pytest.importorskip("cv2")
pd = pytest.importorskip("pandas")

CAMS = ("ring_front_left", "ring_front_center", "ring_front_right")


def write_av2_tree(root: Path) -> Path:
    """The synthetic AV2 split of `tests/test_augmentation.py:av2_tree`,
    exposed as the val, train and test splits."""
    log = root / "sensor" / "val" / "LOG1"
    rng = np.random.default_rng(0)
    lidar_dir = log / "sensors" / "lidar"
    lidar_dir.mkdir(parents=True)
    bev_dir = root / "bev_seg_full_11_14" / "val" / "LOG1"
    bev_dir.mkdir(parents=True)
    step = 50_000_000                      # 20 Hz cams
    lidar_ts = [int(1e9 + i * 2 * step) for i in range(4)]   # 10 Hz lidar
    for ts in lidar_ts:
        (lidar_dir / f"{ts}.feather").touch()
        jras.save_bev_raster(
            bev_dir / f"{ts}.npz",
            (rng.uniform(size=(256, 256, 7)) > 0.7).astype(np.uint8))
    intr_rows, extr_rows = [], []
    for ci, cam in enumerate(CAMS):
        d = log / "sensors" / "cameras" / cam
        d.mkdir(parents=True)
        shape = (96, 64, 3) if cam == "ring_front_center" else (64, 96, 3)
        for i in range(8):
            ts = int(1e9 + i * step + ci)
            img = rng.integers(0, 255, shape, dtype=np.uint8)
            cv2.imwrite(str(d / f"{ts}.jpg"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        intr_rows.append({"sensor_name": cam, "fx_px": 100.0,
                          "fy_px": 100.0, "cx_px": shape[1] / 2,
                          "cy_px": shape[0] / 2, "width_px": shape[1],
                          "height_px": shape[0]})
        extr_rows.append({"sensor_name": cam, "qw": 1.0, "qx": 0.0,
                          "qy": 0.0, "qz": 0.0, "tx_m": 1.0, "ty_m": 0.0,
                          "tz_m": 1.4})
    calib = log / "calibration"
    calib.mkdir()
    pd.DataFrame(intr_rows).to_feather(calib / "intrinsics.feather")
    pd.DataFrame(extr_rows).to_feather(
        calib / "egovehicle_SE3_sensor.feather")
    for split in ("train", "test"):
        os.symlink(root / "sensor" / "val", root / "sensor" / split)
        os.symlink(root / "bev_seg_full_11_14" / "val",
                   root / "bev_seg_full_11_14" / split)
    return root


@pytest.fixture(scope="module")
def av2_tree(tmp_path_factory):
    return write_av2_tree(tmp_path_factory.mktemp("av2"))


def assert_samples_equal(got, want, where=""):
    assert list(got) == list(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")
        else:
            assert g == w, (where, k)


# ---- the dataset -------------------------------------------------------------

MODES = {
    "multi": {},
    "single": {"multi_camera": False},
    "rect": {"square_image": False},
    "augmented": {"augment_cam_img": True, "augment_bev_img": True,
                  "seed": 7},
    "augmented-single": {"multi_camera": False, "augment_cam_img": True,
                         "augment_bev_img": True, "seed": 3},
    "unnormalized": {"normalize_cam_img": False, "cam_res": (24, 40)},
    "mini_dataset": {"mini_dataset": 2},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataset_samples_equal(av2_tree, mode):
    kw = dict(split="val", dataset_dir=str(av2_tree), cam_res=(32, 32))
    kw.update(MODES[mode])
    want_ds, got_ds = JaxDataset(**kw), ArgoverseDataset(**kw)
    assert len(got_ds) == len(want_ds) > 0
    pd.testing.assert_frame_equal(got_ds.table, want_ds.table)
    for i in range(len(want_ds)):
        assert_samples_equal(got_ds[i], want_ds[i], f"{mode}[{i}]")


def test_dataset_resume_and_specific_frames(av2_tree, tmp_path):
    """`eval_generate` skips the samples already in the output tree;
    `specific_frames` keeps the listed (split, log, timestamp) frames;
    `fake_load` serves tokens only; `save_cam_data` writes the same rig."""
    base = dict(split="val", dataset_dir=str(av2_tree), cam_res=(32, 32))
    full = ArgoverseDataset(**base)
    done = full[1]["sample_token"]
    (tmp_path / "gen" / "sample" / done).mkdir(parents=True)
    frames = tmp_path / "frames.pkl"
    rows = full.table.iloc[[0, 3]]
    with open(frames, "wb") as f:
        pickle.dump([("val", r.log_id, int(r.timestamp_ns))
                     for r in rows.itertuples()], f)
    for kw in ({"eval_generate": str(tmp_path / "gen")},
               {"specific_frames": str(frames)},
               {"fake_load": True},
               {"mini_dataset": 3, "eval_generate": str(tmp_path / "gen")}):
        want_ds = JaxDataset(**base, **kw)
        got_ds = ArgoverseDataset(**base, **kw)
        pd.testing.assert_frame_equal(got_ds.table, want_ds.table)
        for i in range(len(want_ds)):
            assert_samples_equal(got_ds[i], want_ds[i], f"{kw}[{i}]")
    tokens = [s["sample_token"] for s in ArgoverseDataset(
        **base, eval_generate=str(tmp_path / "gen"))]
    assert done not in tokens and len(tokens) == len(full) - 1
    JaxDataset(**base).save_cam_data(str(tmp_path / "jax_rig.npz"))
    full.save_cam_data(str(tmp_path / "rig.npz"))
    want, got = np.load(tmp_path / "jax_rig.npz"), np.load(tmp_path / "rig.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dataset_without_sensor_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="ARGOVERSE_DATA_DIR"):
        ArgoverseDataset(split="val", dataset_dir=str(tmp_path))


# ---- the loader --------------------------------------------------------------

class _Samples:
    def __init__(self, n=11):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 2), i, np.float32),
                "cam_name": ["a", "b"], "sample_token": f"t{i}"}


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batch_order_equal(workers, drop_last):
    kw = dict(batch_size=3, shuffle=True, seed=5, num_workers=workers,
              drop_last=drop_last)
    want_dl, got_dl = jdm.DataLoader(_Samples(), **kw), tdm.DataLoader(
        _Samples(), **kw)
    assert len(got_dl) == len(want_dl)
    for epoch in range(3):
        want, got = list(want_dl), list(got_dl)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_samples_equal(g, w, f"epoch {epoch}")


def test_dataset_batches_equal_through_both_loaders(av2_tree):
    kw = dict(split="val", dataset_dir=str(av2_tree), cam_res=(32, 32))
    want = list(jdm.DataLoader(JaxDataset(**kw), 2, shuffle=True, seed=1))
    got = list(tdm.DataLoader(ArgoverseDataset(**kw), 2, shuffle=True, seed=1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_samples_equal(g, w)


def test_datamodule_equal():
    for kw in ({"smoke_test": True}, {"small_val": True, "seed": 4},
               {"val_batch_size": 5}):
        kw = {"batch_size": 3, "num_workers": 0, **kw}
        mods = [m.DataModule(train=_Samples(13), validation=_Samples(17),
                             test=_Samples(7), **kw) for m in (jdm, tdm)]
        for name in ("train_dataloader", "val_dataloader", "test_dataloader"):
            want, got = (list(getattr(m, name)()) for m in mods)
            assert len(got) == len(want), (kw, name)
            for g, w in zip(got, want):
                assert_samples_equal(g, w, f"{kw} {name}")
    sub = tdm.Subset(_Samples(), [4, 2])
    assert len(sub) == 2 and sub[1]["sample_token"] == "t2"


def test_device_prefetch_keeps_order_and_converts():
    batches = list(tdm.DataLoader(_Samples(), 3, num_workers=0))
    out = list(tdm.device_prefetch(iter(batches), "cpu", size=2))
    assert len(out) == len(batches)
    for o, b in zip(out, batches):
        assert isinstance(o["image"], torch.Tensor)
        np.testing.assert_array_equal(o["image"].numpy(), b["image"])
        assert not np.shares_memory(o["image"].numpy(), b["image"])
        assert o["sample_token"] == b["sample_token"]
        assert o["cam_name"] == b["cam_name"]


# ---- raster, sync, camera geometry -------------------------------------------

def _scene(seed):
    rng = np.random.default_rng(seed)

    def poly(n, scale):
        return np.concatenate([rng.uniform(-scale, scale, (n, 2)),
                               np.zeros((n, 1))], 1)

    cats = ["REGULAR_VEHICLE", "BUS", "PEDESTRIAN", "DOG", "BOX_TRUCK"]
    return dict(
        drivable_polygons_ego=[poly(6, 30) for _ in range(3)],
        cuboid_footprints_ego=[(cats[i % 5], poly(4, 25)) for i in range(9)],
        lane_boundaries_ego=[poly(5, 35) for _ in range(4)],
        stoplines_ego=[poly(2, 20) for _ in range(2)],
        ped_crossing_polygons_ego=[poly(4, 15) for _ in range(2)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasters_equal(seed, tmp_path):
    """The BEV raster files, pixel geometry and categories the port's
    dataset relies on; the raster is drawn by the JAX package's
    `rasterize_scene` and crosses the two packages' npz readers."""
    layers = jras.rasterize_scene(**_scene(seed)).astype(np.uint8)
    assert layers.sum() > 0
    tras.save_bev_raster(tmp_path / "port.npz", layers)
    jras.save_bev_raster(tmp_path / "jax.npz", layers)
    for name in ("port.npz", "jax.npz"):
        got = tras.load_bev_raster(tmp_path / name)
        want = jras.load_bev_raster(tmp_path / name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, layers)
    pts = np.random.default_rng(seed).uniform(-50, 50, (20, 3))
    np.testing.assert_array_equal(tras.ego_to_bev_px(pts),
                                  jras.ego_to_bev_px(pts))
    for raw in ("REGULAR_VEHICLE", "BOX_TRUCK", "BUS", "PEDESTRIAN", "DOG",
                *jras.LARGE_VEHICLE_CATS):
        assert tras.standard_category(raw) == jras.standard_category(raw)


def _records(seed):
    rng = np.random.default_rng(seed)
    files = []
    for log in ("LOGA", "LOGB"):
        for cam in CAMS:
            for i in range(10):
                ts = 1_000_000_000 + i * 50_000_000 + int(rng.integers(-3e7, 3e7))
                files.append(Path(f"/r/{log}/sensors/cameras/{cam}/{ts}.jpg"))
        for i in range(5):
            files.append(Path(f"/r/{log}/sensors/lidar/"
                              f"{1_000_000_000 + i * 100_000_000}.feather"))
    return files


def test_sync_tables_equal(tmp_path):
    for seed in range(3):
        files = _records(seed)
        want_r = jsync.build_sensor_records(files, "val")
        got_r = tsync.build_sensor_records(files, "val")
        pd.testing.assert_frame_equal(got_r, want_r)
        want = jsync.synchronize(want_r, "lidar", CAMS)
        got = tsync.synchronize(got_r, "lidar", CAMS)
        pd.testing.assert_frame_equal(got, want)
        pd.testing.assert_frame_equal(tsync.filter_complete(got, CAMS),
                                      jsync.filter_complete(want, CAMS))
        pd.testing.assert_frame_equal(tsync.per_frame_records(got_r, CAMS),
                                      jsync.per_frame_records(want_r, CAMS))
    cache = tmp_path / "c" / "val_sync.feather"
    built = tsync.load_or_build_sync_cache(cache, got_r, "lidar", CAMS)
    assert cache.exists()
    pd.testing.assert_frame_equal(
        tsync.load_or_build_sync_cache(cache, got_r.iloc[:0], "lidar", CAMS),
        jsync.load_or_build_sync_cache(cache, want_r.iloc[:0], "lidar", CAMS))
    pd.testing.assert_frame_equal(built, want)


def test_camera_geometry_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (48, 72, 3), dtype=np.uint8)
    portrait = rng.integers(0, 255, (72, 48, 3), dtype=np.uint8)
    for cam in CAMS + ("ring_side_left", "ring_rear_right"):
        src = portrait if cam == "ring_front_center" else img
        np.testing.assert_array_equal(tcg.square_crop(src, cam),
                                      jcg.square_crop(src, cam))
        assert (tcg.square_crop_offsets(cam, 48, 72)
                == jcg.square_crop_offsets(cam, 48, 72))
    K = np.array([[100.0, 0, 36], [0, 90, 24], [0, 0, 1]])
    for first in (True, False):
        a, b = tcg.CamIntrinsicAdjust(first), jcg.CamIntrinsicAdjust(first)
        for adj in (a, b):
            adj.set_scale(0.5, 0.75)
            adj.set_crop(3, 5)
        np.testing.assert_array_equal(a.apply(K), b.apply(K))
    img01 = img.astype(np.float32) / 255.0
    for seed in range(4):
        pa = tcg.color_jitter_params(np.random.default_rng(seed))
        pb = jcg.color_jitter_params(np.random.default_rng(seed))
        np.testing.assert_array_equal(pa[0], pb[0])
        assert pa[1:] == pb[1:]
        np.testing.assert_array_equal(tcg.apply_color_jitter(img01, pa),
                                      jcg.apply_color_jitter(img01, pb))
        assert (tcg.random_crop_params(np.random.default_rng(seed), 48, 72, .25)
                == jcg.random_crop_params(np.random.default_rng(seed), 48, 72,
                                          .25))
        seg = (rng.uniform(size=(64, 64, 7)) > 0.6).astype(np.uint8)
        for kw in ({}, {"shift_limit": 0.075, "scale_limit": 0.075,
                        "rotate_limit": 10.0, "p_flip": 0.0, "p_ssr": 1.0}):
            np.testing.assert_array_equal(
                tcg.augment_bev(np.random.default_rng(seed), seg, **kw),
                jcg.augment_bev(np.random.default_rng(seed), seg, **kw))
    np.testing.assert_array_equal(tcg.resize_bicubic(img01, (32, 40)),
                                  jcg.resize_bicubic(img01, (32, 40)))
    np.testing.assert_array_equal(tcg.resize_bicubic_uint8(img, (32, 40)),
                                  jcg.resize_bicubic_uint8(img, (32, 40)))
    norm = tcg.normalize_image(img01)
    np.testing.assert_array_equal(norm, jcg.normalize_image(img01))
    np.testing.assert_array_equal(tcg.denormalize_image(norm),
                                  jcg.denormalize_image(norm))


# ---- images, figures and the sample writer ----------------------------------

def test_images_and_figures_equal():
    from bevgen_tpu.utils import image as jimage
    from bevgen_tpu.utils import viz as jviz
    from bevgen_torch.utils import image as timage
    from bevgen_torch.utils import viz as tviz
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(3, 20, 20, 3)).astype(np.float32)
    seg = (rng.uniform(size=(32, 32, 7)) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(timage.make_grid(imgs, nrow=2),
                                  jimage.make_grid(imgs, nrow=2))
    a, b = timage.Im(imgs[0]), jimage.Im(imgs[0])
    for f in (lambda m: m.uint8, lambda m: m.denormalize().uint8,
              lambda m: m.add_border(3).uint8,
              lambda m: m.write_text("x").uint8,
              lambda m: m.resize(10, 14).uint8):
        np.testing.assert_array_equal(f(a), f(b))
    np.testing.assert_array_equal(timage.Im(b.pil).np, b.uint8)
    np.testing.assert_array_equal(tviz.viz_bev(seg).np, jviz.viz_bev(seg).np)
    np.testing.assert_array_equal(
        tviz.scene_figure(imgs, seg, CAMS, imgs[::-1]).np,
        jviz.scene_figure(imgs, seg, CAMS, imgs[::-1]).np)


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def assert_trees_equal(got_root: Path, want_root: Path):
    """Equal file names; npz members byte for byte; other files (JPEG, PNG)
    of equal sizes."""
    names = _tree(want_root)
    assert _tree(got_root) == names and names
    for name in names:
        g, w = got_root / name, want_root / name
        if name.endswith(".npz"):
            with zipfile.ZipFile(g) as zg, zipfile.ZipFile(w) as zw:
                assert zg.namelist() == zw.namelist(), name
                for member in zw.namelist():
                    assert zg.read(member) == zw.read(member), (name, member)
        else:
            assert g.stat().st_size == w.stat().st_size, name


@pytest.mark.parametrize("layout,rand_str,background", [
    ("argoverse", False, True), ("argoverse", True, False),
    ("nuscenes", False, True)])
def test_generation_writers_write_the_same_tree(tmp_path, layout, rand_str,
                                                background):
    from bevgen_tpu.utils.outputs import GenerationWriter as JaxWriter
    from bevgen_torch.utils.outputs import GenerationWriter
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.core.config import tiny_test_config
    rng = np.random.default_rng(2)
    cfg = tiny_test_config()
    batches = [fake_batch(cfg, 2, seed=s) for s in (0, 1)]
    batches[1]["sample_token"] = ["other0", "other1"]
    for root, cls in ((tmp_path / "jax", JaxWriter),
                      (tmp_path / "port", GenerationWriter)):
        random.seed(9)
        writer = cls(str(root), layout=layout, rand_str=rand_str,
                     background=background, max_pending=1)
        for batch in batches:
            gen = rng.standard_normal(batch["image"].shape).astype(np.float32)
            rec = batch["image"] * 0.5
            writer.write_batch(gen, batch, gt_images=batch["image"],
                               rec_images=rec)
        writer.flush()
        rng = np.random.default_rng(2)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_writer_reads_per_sample_camera_names(tmp_path):
    """The loader's collate keeps one list of camera names per sample; the
    writer names each sample's files from its own list."""
    from bevgen_torch.utils.outputs import GenerationWriter
    samples = [{"image": np.zeros((3, 8, 8, 3), np.float32),
                "segmentation": np.zeros((8, 8, 7), np.float32),
                "cam_name": list(CAMS), "sample_token": f"t{i}"}
               for i in range(2)]
    batch = tdm.collate(samples)
    GenerationWriter(str(tmp_path), save_viz=False).write_batch(
        batch["image"], batch, gt_images=batch["image"])
    for t in ("t0", "t1"):
        for sub in ("sample", "sample_gt"):
            assert sorted(p.name for p in (tmp_path / sub / t).glob(
                "*.jpg")) == sorted(f"{c}.jpg" for c in CAMS)


def test_generation_writer_flush_settles_every_future(tmp_path):
    from bevgen_torch.utils.outputs import GenerationWriter
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.core.config import tiny_test_config
    batch = fake_batch(tiny_test_config(), 1, seed=0)
    writer = GenerationWriter(str(tmp_path), background=True)
    writer.write_batch(batch["image"], {**batch, "segmentation": None})
    writer.write_batch(batch["image"], batch)
    with pytest.raises(Exception):
        writer.flush()
    assert writer._pending == []
    assert (tmp_path / "sample" / "fake00000" / "bev.npz").exists()
    writer.flush()   # nothing stale left to raise


# ---- tokenization ------------------------------------------------------------

def _fake_batches(cfg, n, bs=2):
    from bevgen_torch.data.fake import fake_batch
    return [fake_batch(cfg, bs, seed=10 + i) for i in range(n)]


def test_tokenize_shards_equal(tmp_path):
    from bevgen_tpu.data.tokens import tokenize_dataset as jax_tokenize
    from bevgen_torch.data.tokens import TokenDataset, tokenize_dataset
    jp, params, tp = tiny_pipelines()
    batches = _fake_batches(tp.config, 3)
    assert jax_tokenize(jp, params, batches, str(tmp_path / "jax"),
                        shard_size=3) == 6
    assert tokenize_dataset(tp, tdm.device_prefetch(iter(batches), "cpu"),
                            str(tmp_path / "port"), shard_size=3) == 6
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["shard_00000.npz", "shard_00001.npz"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ds = TokenDataset(str(tmp_path / "port"))
    assert len(ds) == 6 and ds[5]["tokens"].shape == (3, 16)


def test_tokenize_then_train_chain(tmp_path, capsys):
    from bevgen_torch.scripts import tokenize_data, train_stage2
    shards = tmp_path / "tokens"
    assert tokenize_data.main([
        "preset=tiny_test", "device=cpu", "dtype=float32", "fake=3",
        "batch_size=2", "shard_size=4", f"out_dir={shards}"]) == 0
    assert "tokenized 6 samples" in capsys.readouterr().out
    assert len(list(shards.glob("shard_*.npz"))) == 2
    assert train_stage2.main([
        "preset=tiny_test", "device=cpu", "steps=2", "batch_size=2",
        f"tokens_dir={shards}", "log_every=1"]) == 0
    steps = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)
    with pytest.raises(SystemExit, match="out_dir"):
        tokenize_data.main(["preset=tiny_test", "device=cpu", "fake=1"])
    with pytest.raises(SystemExit, match="bogus"):
        tokenize_data.main(["preset=tiny_test", "device=cpu", "fake=1",
                            f"out_dir={shards}", "bogus=1"])


def test_tokenize_data_on_the_tree(av2_tree, tmp_path, monkeypatch, capsys):
    from bevgen_torch.scripts import tokenize_data
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(av2_tree))
    assert tokenize_data.main([
        "preset=tiny_test", "device=cpu", "dtype=float32", "batch_size=2",
        f"out_dir={tmp_path}"]) == 0
    assert "tokenized 4 samples" in capsys.readouterr().out
    shard = np.load(tmp_path / "shard_00000.npz")
    assert shard["tokens"].shape == (4, 3, 16)
    assert list(shard["sample_token"])[0].startswith("LOG1_")


# ---- the generate CLI on the tree --------------------------------------------

# tiny_test with a BEV encoder that takes the tree's 256x256 rasters to
# 16x16 latents
TINY_CLI = ["preset=tiny_test", "device=cpu", "dtype=float32",
            "muse.sample_iterations=2", "cond_stage.ch=8",
            "cond_stage.ch_mult=(1,1,1,1,1)", "transformer.bev_latent_res=(16,16)"]


def test_cli_real_data_writes_the_reference_tree(av2_tree, tmp_path,
                                                 monkeypatch, capsys):
    from bevgen_tpu.utils.outputs import GenerationWriter as JaxWriter
    from bevgen_torch.scripts import generate as cli
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(av2_tree))
    tree = tmp_path / "eval"
    _, paths = cli.run(TINY_CLI + [
        "batch_size=2", f"eval_generate={tree}", f"out={tmp_path / 'npz'}",
        "save_rec=true", "keep_cameras=ring_front_center"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["images"] == 12
    assert len(paths) == 2
    # the JAX writer, given the same batches and images, writes the same
    # tree; it reads the camera names as cam_name[c][b] (torch's
    # default_collate layout), so it is handed one list for the batch
    ds = JaxDataset(split="val", dataset_dir=str(av2_tree), cam_res=(32, 32))
    writer = JaxWriter(str(tmp_path / "jax"))
    for batch, path in zip(jdm.DataLoader(ds, 2), paths):
        got = np.load(path)
        assert batch["cam_name"] == [list(CAMS)] * 2
        writer.write_batch(got["images"], {**batch, "cam_name": list(CAMS)},
                           gt_images=batch["image"], rec_images=got["rec"])
    assert_trees_equal(tree, tmp_path / "jax")
    assert {p.name for p in (tree / "sample_rec").iterdir()} == {
        s["sample_token"] for s in ds}
    # resume: a second run finds every sample written and serves none
    _, again = cli.run(TINY_CLI + ["batch_size=2", f"eval_generate={tree}",
                                   f"out={tmp_path / 'npz2'}"])
    assert again == []
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "images"] == 0
    # mini_dataset and limit_batches cut the served samples; without out=
    # only the eval_generate tree is written
    monkeypatch.chdir(tmp_path)
    _, cut = cli.run(TINY_CLI + ["batch_size=1", "mini_dataset=3",
                                 "limit_batches=2", "rand_str=true",
                                 f"eval_generate={tmp_path / 'cut'}"])
    assert cut == [] and not (tmp_path / "output").exists()
    assert len(list((tmp_path / "cut" / "sample").iterdir())) == 2


def test_cli_real_data_exits_on_bad_arguments(av2_tree, tmp_path,
                                              monkeypatch):
    from bevgen_torch.scripts import generate as cli
    from bevgen_torch.scripts import tokenize_data
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(av2_tree))
    seven = ["transformer.num_cams=7",
             "transformer.cam_names=ARGOVERSE_RING_CAMERAS"]
    with pytest.raises(SystemExit, match=r"3 cameras.*num_cams=7"):
        cli.run(TINY_CLI + seven + [f"out={tmp_path}"])
    with pytest.raises(SystemExit, match=r"3 cameras.*num_cams=7"):
        tokenize_data.main(TINY_CLI + seven + [f"out_dir={tmp_path / 'tok'}"])
    for flag in ("false", "true"):
        with pytest.raises(SystemExit, match="sample count"):
            cli.run(TINY_CLI + [f"mini_dataset={flag}", f"out={tmp_path}"])
    with pytest.raises(SystemExit, match="bogus"):
        cli.run(TINY_CLI + ["bogus=1", f"out={tmp_path}"])
    with pytest.raises(SystemExit):
        cli.run(TINY_CLI + ["transformer.bogus=1", f"out={tmp_path}"])
    with pytest.raises(FileNotFoundError):
        cli.run(TINY_CLI + ["datamodule.split=nope", f"out={tmp_path}"])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["argoverse_muse", "nuscenes_ar"])
def test_yaml_configs_equal_the_reference(name):
    from bevgen_tpu.scripts import cli as jcli
    from bevgen_torch.scripts import cli as tcli
    root = Path(__file__).resolve().parent.parent
    got = tcli.load_yaml_config(str(root / "bevgen_torch" / "configs"
                                    / f"{name}.yaml"))
    want = jcli.load_yaml_config(str(root / "bevgen_tpu" / "configs"
                                     / f"{name}.yaml"))
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), g.name
        else:
            assert a == b, f.name
    args = {"datamodule.split": "val"}
    cfg = tcli.apply_modes(got, "[argoverse,generate]", args)
    jargs = {"datamodule.split": "val"}
    jc = jcli.apply_modes(want, "[argoverse,generate]", jargs)
    assert args == jargs == {"datamodule.split": "val"}
    assert cfg.transformer.cam_res == jc.transformer.cam_res == (256, 256)


def test_cli_yaml_config_and_modes_on_the_tree(av2_tree, tmp_path,
                                               monkeypatch, capsys):
    """`config=<yaml> modes=[argoverse,generate]`: the mode's 256-pixel,
    16x16-latent cameras on a tiny model, on the split the mode picks
    (test)."""
    from bevgen_torch.scripts import generate as cli
    monkeypatch.setenv("ARGOVERSE_DATA_DIR", str(av2_tree))
    cfg = tmp_path / "tiny.yaml"
    s1 = ("  ch: 8\n  ch_mult: [1, 1, 1, 1, 1]\n  num_res_blocks: 1\n"
          "  z_channels: 8\n  n_embed: 16\n  embed_dim: 8\n"
          "  attn_resolutions: [16]\n")
    cfg.write_text("preset: tiny_test\nbatch_size: 2\ndtype: float32\n"
                   "transformer:\n  vocab_size: 16\n  cond_vocab_size: 16\n"
                   "  bev_latent_res: [16, 16]\n  window_len: 8\n"
                   "muse:\n  sample_iterations: 2\n"
                   f"first_stage:\n{s1}cond_stage:\n{s1}")
    pipe, paths = cli.run([f"config={cfg}", "modes=[argoverse,generate]",
                           "device=cpu", f"out={tmp_path / 'out'}",
                           f"eval_generate={tmp_path / 'eval'}"])
    tf = pipe.config.transformer
    assert tf.cam_res == (256, 256) and tf.cam_latent_res == (16, 16)
    out = np.load(paths[0])
    assert out["images"].shape == (2, 3, 256, 256, 3)
    assert out["ids"].shape == (2, 3, 16, 16)
    assert len(list((tmp_path / "eval" / "sample").iterdir())) == 4
    with pytest.raises(SystemExit, match="not both"):
        cli.run([f"config={cfg}", "preset=tiny_test", "device=cpu"])
    with pytest.raises(SystemExit, match="unknown mode"):
        cli.run(["preset=tiny_test", "modes=[nope]", "device=cpu"])
