"""The port's BEV raster drawing against the JAX package on the CPU: the
native C++ core (`bevgen_torch/native.py`, built from
`bevgen_torch/csrc/rasterize.cpp`) equals `bevgen_tpu.native` bit for bit
on seeded polygons and polylines and on `tests/test_native.py`'s city-scale
case (with its 1 s bound); the cv2 route and `rasterize_scene` on both
routes equal the JAX module's bit for bit; native against cv2 at
`tests/test_native.py`'s IoU bounds; and the two routes that raise where
the JAX module falls back quietly: no cv2, and a native build that fails.
"""
import sys
import time

import numpy as np
import pytest
import torch

from bevgen_torch import native as tnative
from bevgen_torch.data import rasterize as trast
from bevgen_tpu import native as jnative
from bevgen_tpu.data import rasterize as jrast

SHAPE = (256, 256)


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
def built():
    """Both cores built (the port's into bevgen_torch/build/)."""
    assert jnative.available(), jnative.build_error()
    assert tnative.available(), tnative.build_error()
    path = tnative.library_path(tnative.SRC)
    assert path.parent == tnative.BUILD_DIR and path.exists()
    return path


def _iou(a, b):
    a, b = a > 0, b > 0
    return (a & b).sum() / max((a | b).sum(), 1)


def _random_polygons(rng, n):
    """Star-shaped, self-intersecting and partly off-raster polygons."""
    polys = []
    for i in range(n):
        k = int(rng.integers(3, 9))
        center = rng.uniform(-40, 296, 2)
        ang = rng.uniform(0, 2 * np.pi, k)
        if i % 2 == 0:
            ang = np.sort(ang)       # simple (star-shaped) on even draws
        r = rng.uniform(2, 90, k)
        polys.append(np.stack([center[0] + r * np.cos(ang),
                               center[1] + r * np.sin(ang)], 1)
                     .astype(np.int32))
    return polys


def _random_polylines(rng, n):
    return [rng.integers(-300, 556, (int(rng.integers(2, 7)), 2))
            .astype(np.int32) for _ in range(n)]


def _city_scale():
    rng = np.random.default_rng(0)
    far = rng.integers(5_000, 30_000, (5000, 2, 2)).astype(np.int32)
    crossing = np.array([[-20_000, 128], [20_000, 128]], np.int32)
    polys = [s.reshape(-1, 2) for s in
             rng.integers(5_000, 30_000, (2000, 3, 2)).astype(np.int32)]
    return [s for s in far] + [crossing], polys, crossing


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_fills_equal_the_jax_core(built, seed):
    rng = np.random.default_rng(seed)
    polys = _random_polygons(rng, 12)
    lines = _random_polylines(rng, 12)
    for shape in (SHAPE, (32, 48)):
        got = tnative.fill_polygons(polys, shape)
        np.testing.assert_array_equal(got, jnative.fill_polygons(polys, shape))
        assert got.sum() > 0 or shape != SHAPE
        got = tnative.draw_polylines(lines, shape)
        np.testing.assert_array_equal(got,
                                      jnative.draw_polylines(lines, shape))
        # one at a time too, and the empty list
        for p in polys[:4]:
            np.testing.assert_array_equal(tnative.fill_polygons([p], shape),
                                          jnative.fill_polygons([p], shape))
    assert tnative.fill_polygons([], SHAPE).sum() == 0


def test_native_city_scale_geometry_is_bounded_and_equal(built):
    """tests/test_native.py's city-scale case (coordinates up to ~30,000
    px): within its 1 s bounds, only the crossing line lands, and both
    cores draw the same pixels."""
    lines, polys, crossing = _city_scale()
    t0 = time.perf_counter()
    img = tnative.draw_polylines(lines, SHAPE)
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"native polylines took {dt:.2f}s on culled-free input"
    assert img.sum() == 256 and img[128].sum() == 256
    np.testing.assert_array_equal(img, jnative.draw_polylines(lines, SHAPE))
    t0 = time.perf_counter()
    pimg = tnative.fill_polygons(polys, SHAPE)
    assert time.perf_counter() - t0 < 1.0
    assert pimg.sum() == 0
    np.testing.assert_array_equal(pimg, jnative.fill_polygons(polys, SHAPE))
    import cv2
    ref = np.zeros(SHAPE, np.uint8)
    cv2.polylines(ref, [crossing], isClosed=False, color=1, thickness=1)
    assert (tnative.draw_polylines([crossing], SHAPE) == ref).mean() > 0.999


def test_native_against_cv2_at_the_jax_bounds(built):
    """tests/test_native.py's parity bounds against cv2: fills IoU > 0.97,
    the polyline IoU > 0.85 within 30 pixels."""
    import cv2
    rng = np.random.default_rng(0)
    for trial in range(5):
        n = rng.integers(3, 8)
        center = rng.uniform(40, 216, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(10, 60, n)
        poly = np.stack([center[0] + r * np.cos(ang),
                         center[1] + r * np.sin(ang)], 1).astype(np.int32)
        ref = np.zeros(SHAPE, np.uint8)
        cv2.fillPoly(ref, [poly], 1)
        assert _iou(tnative.fill_polygons([poly], SHAPE), ref) > 0.97, trial
    line = np.array([[10, 10], [200, 50], [100, 240]], np.int32)
    ours = tnative.draw_polylines([line], SHAPE)
    ref = np.zeros(SHAPE, np.uint8)
    cv2.polylines(ref, [line], False, 1, 1)
    assert _iou(ours, ref) > 0.85
    assert abs(int(ours.sum()) - int(ref.sum())) < 30


def test_cv2_route_equals_the_jax_module(monkeypatch):
    monkeypatch.delenv("BEVGEN_NATIVE_RASTER", raising=False)
    rng = np.random.default_rng(3)
    polys = _random_polygons(rng, 10)
    lines = _random_polylines(rng, 10)
    np.testing.assert_array_equal(trast.fill_polygons(polys),
                                  jrast.fill_polygons(polys))
    for thickness in (1, 3):
        np.testing.assert_array_equal(
            trast.draw_polylines(lines, thickness=thickness),
            jrast.draw_polylines(lines, thickness=thickness))
    pts = rng.normal(0, 50, (20, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t = rng.normal(0, 100, 3)
    np.testing.assert_array_equal(trast.city_to_ego(pts, R, t),
                                  jrast.city_to_ego(pts, R, t))


def _scene(rng):
    def quad(x, y, yaw, l, w):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        corners = np.array([[l, w, 0], [l, -w, 0], [-l, -w, 0], [-l, w, 0]])
        return (R @ corners.T).T + np.array([x, y, 0.0])

    cats = ("REGULAR_VEHICLE", "BUS", "PEDESTRIAN", "BICYCLE", "TRUCK")
    cuboids = [(cats[i % 5], quad(*rng.uniform(-45, 45, 2),
                                  rng.uniform(0, 6.3), *rng.uniform(0.4, 6, 2)))
               for i in range(14)]
    return dict(
        drivable_polygons_ego=[np.array(
            [[-30, -20, 0], [-30, 25, 0], [35, 25, 0], [35, -20, 0]], float),
            rng.uniform(-60, 60, (6, 3))],
        cuboid_footprints_ego=cuboids,
        lane_boundaries_ego=[rng.uniform(-500, 500, (5, 3)) for _ in range(6)],
        stoplines_ego=[rng.uniform(-40, 40, (2, 3)) for _ in range(3)],
        ped_crossing_polygons_ego=[rng.uniform(-40, 40, (4, 3))])


@pytest.mark.parametrize("route", ["cv2", "native"])
def test_rasterize_scene_equals_the_jax_module(built, monkeypatch, route):
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER",
                       "1" if route == "native" else "0")
    for seed in range(3):
        scene = _scene(np.random.default_rng(seed))
        for res in (256, 32):
            got = trast.rasterize_scene(**scene, resolution=res)
            want = jrast.rasterize_scene(**scene, resolution=res)
            assert got.dtype == np.float32 and got.shape == (res, res, 7)
            np.testing.assert_array_equal(got, want)
        assert got.sum() > 0


def test_rasterize_scene_native_against_cv2(built, monkeypatch):
    """tests/test_native.py's scene: native and cv2 rasters agree (IoU >
    0.95 a channel)."""
    quad = np.array([[8, -1, 0], [8, 1, 0], [12, 1, 0], [12, -1, 0]], float)
    scene = dict(
        drivable_polygons_ego=[np.array(
            [[-20, -20, 0], [-20, 20, 0], [20, 20, 0], [20, -20, 0]], float)],
        cuboid_footprints_ego=[("REGULAR_VEHICLE", quad)],
        lane_boundaries_ego=[np.array([[0, -5, 0], [20, -5, 0]])],
        stoplines_ego=[], ped_crossing_polygons_ego=[])
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER", "1")
    layers = trast.rasterize_scene(**scene)
    assert layers[..., 0].sum() > 0 and layers[..., 4].sum() > 1000
    assert layers[..., 5].sum() > 0
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER", "0")
    ref = trast.rasterize_scene(**scene)
    for c in range(7):
        assert _iou(layers[..., c], ref[..., c]) > 0.95 or ref[..., c].sum() == 0


def test_no_cv2_raises_naming_both_routes(built, monkeypatch):
    """Without cv2 the default route raises (the JAX module returns an empty
    raster); the native route draws."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.delenv("BEVGEN_NATIVE_RASTER", raising=False)
    poly = [np.array([[10, 10], [100, 10], [50, 90]], np.int32)]
    for call in (lambda: trast.fill_polygons(poly),
                 lambda: trast.draw_polylines(poly),
                 lambda: trast.fill_polygons([]),
                 lambda: trast.rasterize_scene([], [], [], [], [])):
        with pytest.raises(ImportError, match="BEVGEN_NATIVE_RASTER=1"):
            call()
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER", "1")
    assert trast.fill_polygons(poly).sum() > 0
    with pytest.raises(ImportError, match="cv2"):  # thickness 3 needs cv2
        trast.draw_polylines(poly, thickness=3)


def test_failed_native_build_raises_with_the_compiler_output(monkeypatch,
                                                            tmp_path):
    """A source that does not compile: `available()` is False,
    `build_error()` holds g++'s message, and drawing through the native
    route raises with it (the JAX module quietly draws with cv2)."""
    bad = tmp_path / "rasterize.cpp"
    bad.write_text("extern \"C\" void fill_polygons( {\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    assert not tnative.available()
    assert "error" in tnative.build_error()
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER", "1")
    poly = [np.array([[10, 10], [100, 10], [50, 90]], np.int32)]
    for call in (lambda: trast.fill_polygons(poly),
                 lambda: trast.draw_polylines(poly),
                 lambda: tnative.fill_polygons(poly, SHAPE)):
        with pytest.raises(RuntimeError, match="(?s)did not build.*error"):
            call()
    monkeypatch.setattr(tnative, "SRC", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="source missing"):
        trast.fill_polygons(poly)
    assert not list((tmp_path / "build").glob("*.so"))


def test_enable_sets_the_route(monkeypatch):
    monkeypatch.setenv("BEVGEN_NATIVE_RASTER", "0")  # undone after the test
    tnative.enable()
    import os
    assert os.environ["BEVGEN_NATIVE_RASTER"] == "1"
    pts, lens, n = tnative._pack([np.zeros((3, 2)), np.ones((2, 2))])
    jpts, jlens, jn = jnative._pack([np.zeros((3, 2)), np.ones((2, 2))])
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(lens, jlens)
    assert n == jn == 2
