"""The scene editor of the port (`scripts/edit_scene.py`,
`scripts/edit_server.py`) against the JAX package on the CPU at
`tiny_test`: `apply_edits` and `cuboid_quads` equal JAX's; the edit_scene
CLI writes the 3 cameras' JPEGs; on one numpy weight tree (fp32, greedy
decodes: `tests/torch_parity.py`) `EditSession.generate`'s raster equals a
JAX `EditSession`'s exactly, its ids equal the JAX session's jitted
generate's and its images within 1e-4; `_png_uri`'s pixels, decoded with
PIL, equal the JAX server's PIL PNGs exactly; and the server end to end
(page, annotations, generate, a repeated request bit for bit, an added
vehicle, a malformed body's HTTP 400), each served image equal to a direct
`generate_fn` call's, bit for bit.
"""
import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bevgen_torch.scripts import edit_scene as tedit
from bevgen_torch.scripts import edit_server as tserver
from bevgen_tpu.scripts import edit_scene as jedit
from bevgen_tpu.scripts import edit_server as jserver
from torch_parity import tiny_configs, tiny_pipelines

EDITS = [{"op": "add", "category": "REGULAR_VEHICLE", "x": 10, "y": 0,
          "yaw": 0.3, "length": 4.5, "width": 2.0},
         {"op": "add", "category": "PEDESTRIAN", "x": -6.5, "y": 2.25,
          "length": 0.8, "width": 0.7},
         {"op": "add", "category": "BUS", "x": 3, "y": -8, "yaw": -1.2,
          "length": 11, "width": 2.6},
         {"op": "remove", "index": 0}, {"op": "remove", "index": 7}]
# in tiny_test's 32x32 raster (the ego window's rear-left corner)
CORNER_CAR = {"category": "REGULAR_VEHICLE", "x": -34.0, "y": 34.0,
              "yaw": 0.0, "length": 4.0, "width": 4.0}


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
def sessions():
    """(port session, JAX session) at tiny_test, fp32, greedy, on the same
    weights: the port's `EditSession` on the CPU with the parity pipeline's
    weights, and a JAX `EditSession` around the fp32 JAX pipeline with
    `params` set to the same tree."""
    jc, tc = tiny_configs(greedy=True)
    jp, params, tp = tiny_pipelines(greedy=True)
    port = tserver.EditSession(dataclasses.replace(tc, dtype="float32"),
                               device="cpu")
    port.pipe.load_state_dict(tp.state_dict())
    js = jserver.EditSession.__new__(jserver.EditSession)
    js.cfg, js.pipe, js.params = jc, jp, params
    js._run = jax.jit(jp.generate_fn)
    js.annotations = [dict(r) for r in jserver._DEFAULT_CUBOIDS]
    return port, js


def test_apply_edits_and_cuboid_quads_equal_jax():
    base = [("OTHER", np.arange(12.0).reshape(4, 3))]
    got, want = tedit.apply_edits(base, EDITS), jedit.apply_edits(base, EDITS)
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rows = tserver._DEFAULT_CUBOIDS + [
        CORNER_CAR, {"category": "PEDESTRIAN", "x": "6", "y": 2, "yaw": "0.5",
                     "length": 0.8, "width": "0.8"},
        {"x": 1, "y": 1, "length": 2, "width": 1}]
    got, want = tserver.cuboid_quads(rows), jserver.cuboid_quads(rows)
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tserver._DEFAULT_CUBOIDS == jserver._DEFAULT_CUBOIDS


def test_edit_scene_cli_writes_the_cameras(tmp_path):
    edits = json.dumps(EDITS[:3])
    tedit.main(["preset=tiny_test", "device=cpu", f"out_dir={tmp_path}",
                f"edits={edits}", "muse.sample_iterations=2"])
    jpgs = sorted((tmp_path / "sample" / "edited").glob("*.jpg"))
    assert len(jpgs) == 3  # tiny_test has 3 cameras
    assert (tmp_path / "sample" / "edited" / "bev.npz").exists()
    images, batch, raster = tedit.run(
        ["preset=tiny_test", "device=cpu", f"edits={edits}",
         "muse.sample_iterations=2", "dtype=float32", "seed=3"])
    assert images.shape == (1, 3, 32, 32, 3) and np.isfinite(images).all()
    from bevgen_tpu.data import rasterize as jrast
    want = jrast.rasterize_scene(
        [np.array(tedit.DRIVABLE_SQUARE)], jedit.apply_edits([], EDITS[:3]),
        [], [], [], resolution=32)
    np.testing.assert_array_equal(raster, want)
    np.testing.assert_array_equal(batch["segmentation"][0], raster)
    with pytest.raises(SystemExit, match="unknown"):
        tedit.run(["preset=tiny_test", "device=cpu", "bogus=1"])


def test_session_generate_equals_the_jax_session(sessions):
    port, js = sessions
    rows = tserver._DEFAULT_CUBOIDS + [CORNER_CAR]
    out = port.generate(rows, seed=2)
    seg = port.last["segmentation"]
    np.testing.assert_array_equal(seg, js.rasterize(rows))
    assert seg[..., 0].sum() > 0   # the corner car is in the 32x32 window
    from bevgen_tpu.data.fake import fake_batch
    batch = fake_batch(js.cfg, batch_size=1, seed=2)
    images, ids = js._run(js.params, jnp.asarray(seg[None]),
                          jnp.asarray(batch["intrinsics_inv"]),
                          jnp.asarray(batch["extrinsics_inv"]),
                          jax.random.PRNGKey(3))
    np.testing.assert_array_equal(port.last["ids"].numpy(), np.asarray(ids))
    np.testing.assert_allclose(port.last["images"],
                               np.asarray(images, np.float32)[0], atol=1e-4)
    want = js.generate(rows, seed=2)
    assert set(out) == set(want) == {"bev", "cameras", "ms"}
    assert list(out["cameras"]) == list(want["cameras"])
    # the BEV image is drawn from the same raster: equal pixels
    np.testing.assert_array_equal(_decode(out["bev"]), _decode(want["bev"]))
    for name in out["cameras"]:
        got, ref = _decode(out["cameras"][name]), _decode(want["cameras"][name])
        # uint8 of images equal within 1e-4: a pixel may round the other way
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert set(port.last["ms"]) == {"rasterize", "generate", "encode"}


def _decode(uri: str) -> np.ndarray:
    assert uri.startswith("data:image/png;base64,")
    return np.asarray(Image.open(io.BytesIO(
        base64.b64decode(uri.split(",", 1)[1]))))


def test_png_uri_pixels_equal_the_pil_encoder():
    rng = np.random.default_rng(0)
    for shape in ((32, 48, 3), (7, 5, 3), (16, 16), (9, 11, 4), (1, 1, 3)):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        got, want = _decode(tserver._png_uri(arr)), _decode(
            jserver._png_uri(arr))
        assert got.shape == shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError, match="channels"):
        tserver._png_uri(np.zeros((4, 4, 2), np.uint8))


def _post(base, body: bytes):
    req = urllib.request.Request(f"{base}/api/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req).read())


def test_edit_server_end_to_end(sessions):
    """As tests/test_aux.py's edit server test, on the port's session; the
    served images equal a direct generate_fn call's bit for bit."""
    port, _ = sessions
    cfg = port.cfg
    srv = tserver.make_server(port, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(f"{base}/").read().decode()
        assert "scene editor" in page and "/api/generate" in page
        anns = json.loads(urllib.request.urlopen(
            f"{base}/api/annotations").read())
        assert anns == tserver._DEFAULT_CUBOIDS
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope")
        assert e.value.code == 404

        body = json.dumps({"cuboids": anns, "seed": 1}).encode()
        out = _post(base, body)
        seg, ids = port.last["segmentation"], port.last["ids"]
        assert out["bev"].startswith("data:image/png;base64,")
        assert len(out["cameras"]) == 3  # tiny_test cameras
        assert _decode(out["bev"]).shape == (cfg.cond_stage.resolution,) * 2 + (3,)
        again = _post(base, body)
        assert {k: v for k, v in again.items() if k != "ms"} == \
            {k: v for k, v in out.items() if k != "ms"}

        # the served images are one generate_fn call's
        from bevgen_torch.data import camera_geometry as cg
        from bevgen_torch.data.fake import fake_batch
        batch = fake_batch(cfg, batch_size=1, seed=1)
        images, direct_ids = port.pipe.generate_fn(
            seg[None], batch["intrinsics_inv"], batch["extrinsics_inv"],
            torch.Generator().manual_seed(2))
        assert torch.equal(direct_ids, ids)
        for i, name in enumerate(cfg.transformer.camera_names):
            rgb = np.clip(cg.denormalize_image(images.float().numpy()[0, i]),
                          0, 1)
            np.testing.assert_array_equal(_decode(out["cameras"][name]),
                                          (rgb * 255).astype(np.uint8))

        added = _post(base, json.dumps(
            {"cuboids": anns + [CORNER_CAR], "seed": 1}).encode())
        assert added["bev"] != out["bev"]
        assert (port.last["segmentation"][..., 0].sum() >
                seg[..., 0].sum())

        bad = urllib.request.Request(
            f"{base}/api/generate", data=b"{not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    finally:
        srv.shutdown()
        srv.server_close()
