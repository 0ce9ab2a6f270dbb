"""The nuScenes reader of the PyTorch port (`data/nuscenes.py`,
`data/nuscenes_raster.py`) against the JAX package's, on the CPU.

On the JAX tests' synthetic v1.0-mini tree (`tests/test_data.py:
_write_nuscenes_fixture`: one scene, six cameras and the lidar, a car
annotation per sample) both `NuScenesDataset`s give the same samples key for
key: images and segmentation exactly, the camera matrices and their
inverses within 1e-6. The shipped scene splits, the table joins, every
raster function and the quaternion and pose helpers give the same results on
seeded inputs.
"""
import numpy as np
import pytest

from bevgen_tpu.data import nuscenes as jns
from bevgen_tpu.data import nuscenes_raster as jnr
from bevgen_torch.data import nuscenes as tns
from bevgen_torch.data import nuscenes_raster as tnr
from test_data import _write_nuscenes_fixture


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    return root, _write_nuscenes_fixture(root, n_samples=3)


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in ("image", "segmentation"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("intrinsics", "extrinsics", "intrinsics_inv", "extrinsics_inv"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    for key in ("cam_name", "sample_token", "dataset"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("cam_res,normalize", [((16, 24), True),
                                               ((32, 48), False)])
def test_dataset_samples_equal(tree, cam_res, normalize):
    root, version = tree
    kw = dict(version=version, dataset_dir=str(root), cam_res=cam_res,
              scene_names=["scene-9999"], normalize_cam_img=normalize)
    got, want = tns.NuScenesDataset(**kw), jns.NuScenesDataset(**kw)
    assert len(got) == len(want) == 3
    for i in range(len(got)):
        assert_samples_equal(got[i], want[i])
    # the car is drawn into its channel (after 2 static + 2 divider ones)
    assert got[0]["segmentation"][..., 4].sum() > 0


def test_tables_equal(tree):
    root, version = tree
    got, want = tns.NuScenesTables(root, version), jns.NuScenesTables(root,
                                                                      version)
    assert got.t == want.t
    assert got.sample_data_by_sample == want.sample_data_by_sample
    assert got.anns_by_sample == want.anns_by_sample
    assert (got.samples_in_scenes(["scene-9999"])
            == want.samples_in_scenes(["scene-9999"]))
    ann = next(iter(got.t["sample_annotation"].values()))
    assert got.category_name(ann) == want.category_name(ann) == "vehicle.car"
    with pytest.raises(FileNotFoundError, match="NUSCENES_DATA_DIR"):
        tns.NuScenesTables(root, "v1.0-missing")


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_scene_split_equal(split):
    got = tns.scene_split(split)
    assert got == jns.scene_split(split)
    assert len(got) == {"train": 700, "val": 150, "test": 6}[split]


def test_unknown_split_raises():
    with pytest.raises(ValueError, match="unknown nuScenes split"):
        tns.scene_split("bogus")


def _quats(rng, n=8):
    q = rng.standard_normal((n, 4))
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1] = [0.924, 0.0, 0.0, 0.383]
    return q


def _pose_inverse(rng):
    q = rng.standard_normal(4)
    return jns.se3(q, rng.uniform(-50, 50, 3), inv=True)


def _polygons(rng, n=4):
    """Global-frame polygons around a pose near the origin: some inside the
    80 m window, one partly outside, one degenerate (2 points)."""
    polys = [np.c_[rng.uniform(-30, 30, (k, 2)), rng.uniform(-1, 1, k)]
             for k in (3, 5, 6, 4)[:n]]
    polys.append(np.c_[rng.uniform(-60, 60, (5, 2)), np.zeros(5)])
    polys.append(np.zeros((2, 3)))
    return polys


def _boxes(rng, n=5):
    return [jnr.box_bottom_corners(rng.uniform(-30, 30, 3),
                                   rng.uniform(1, 5, 3), rng.uniform(-3, 3))
            for _ in range(n)]


CASES = {
    "category_index": lambda m, rng: [
        m.category_index(n) for n in (
            "vehicle.car", "human.pedestrian.adult", "vehicle.construction",
            "vehicle.bus.rigid", "movable_object.barrier", "vehicle.bicycle",
            "static_object.bicycle_rack")],
    "global_to_bev": lambda m, rng: m.global_to_bev(
        rng.uniform(-40, 40, (20, 3)), _pose_inverse(rng)),
    "raster_polygons": lambda m, rng: m.raster_polygons(
        [rng.integers(-20, 280, (k, 2)) for k in (3, 4, 7, 2)]),
    "raster_lines": lambda m, rng: [m.raster_lines(
        [rng.integers(-20, 280, (k, 2)) for k in (2, 5, 1)], thickness=t)
        for t in (1, 2, 3)],
    "get_static_layers": lambda m, rng: m.get_static_layers(
        {"lane": _polygons(rng), "road_segment": _polygons(rng, 2)},
        _pose_inverse(rng)),
    "get_line_layers": lambda m, rng: m.get_line_layers(
        {"road_divider": _polygons(rng), "lane_divider": _polygons(rng, 1)},
        np.eye(4)),
    "box_bottom_corners": lambda m, rng: [m.box_bottom_corners(
        rng.uniform(-9, 9, 3), rng.uniform(1, 5, 3), rng.uniform(-3, 3))
        for _ in range(4)],
    "get_dynamic_layers": lambda m, rng: m.get_dynamic_layers(
        {"car": _boxes(rng), "pedestrian": _boxes(rng, 2), "bus": []},
        np.eye(4)),
    "get_dynamic_objects": lambda m, rng: m.get_dynamic_objects(
        _boxes(rng, 6), np.eye(4)),
    "parse_pose": lambda m, rng: [m.parse_pose(
        rng.uniform(-9, 9, 3), jns.quat_to_rotmat(rng.standard_normal(4)),
        inv=inv) for inv in (False, True)],
    "quat_to_rotmat": lambda m, rng: [m.quat_to_rotmat(q) for q in _quats(rng)]
    + [m.quat_to_rotmat([0.0, 0.0, 0.0, 0.0])],
    "quat_yaw": lambda m, rng: [m.quat_yaw(q) for q in _quats(rng)],
    "pose_flat": lambda m, rng: [m.pose_flat(q, rng.uniform(-9, 9, 3), inv=inv)
                                 for q in _quats(rng, 4)
                                 for inv in (False, True)],
    "se3": lambda m, rng: [m.se3(q, rng.uniform(-9, 9, 3), inv=inv)
                           for q in _quats(rng, 4) for inv in (False, True)],
}
RASTER = {"category_index", "global_to_bev", "raster_polygons",
          "raster_lines", "get_static_layers", "get_line_layers",
          "box_bottom_corners", "get_dynamic_layers", "get_dynamic_objects",
          "parse_pose"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_functions_equal(name):
    """The same seeded inputs through both modules: equal results, dtypes
    and shapes."""
    pair = (tnr, jnr) if name in RASTER else (tns, jns)
    got = CASES[name](pair[0], np.random.default_rng(7))
    want = CASES[name](pair[1], np.random.default_rng(7))
    if name == "category_index":
        assert got == want == [0, 5, 4, 2, None, 7, None]
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name.startswith(("raster", "get_")):
        assert got.any(), "the case draws nothing"


def test_module_constants_equal():
    np.testing.assert_array_equal(tnr.VIEW, jnr.VIEW)
    np.testing.assert_array_equal(tnr.S, jnr.S)
    assert tnr.BEV == jnr.BEV
    for name in ("STATIC_CLASSES", "DIVIDER_CLASSES", "DYNAMIC_CLASSES"):
        assert getattr(tnr, name) == getattr(jnr, name)
    assert tns.NUSCENES_CAMERAS == jns.NUSCENES_CAMERAS
