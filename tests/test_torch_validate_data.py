"""`scripts/validate_data.py` of the PyTorch port against the JAX package's,
on the CPU: each case of `tests/test_validate_data.py` writes the same
synthetic Argoverse 2 or nuScenes tree (the JAX tests' `_write_av2_tree` and
`_write_nuscenes_fixture`, with the same corruption), and both packages'
validators walk it. Their issues (severity, path and message), their
summary JSON lines and their exit codes are equal, and the case's own
finding is there. The CLI exits on an unknown argument.
"""
import json
import shutil

import numpy as np
import pandas as pd
import pytest

from bevgen_tpu.scripts import validate_data as jvd
from bevgen_torch.scripts import validate_data as tvd
from test_data import _write_nuscenes_fixture
from test_validate_data import CAMS, _write_av2_tree


def _clean(root):
    _write_av2_tree(root)
    return {}


def _missing_calibration_column(root):
    log, _ = _write_av2_tree(root)
    f = log / "calibration" / "intrinsics.feather"
    pd.read_feather(f).rename(columns={"fx_px": "focal_x"}).to_feather(f)
    return {}


def _bad_timestamp_filename(root):
    log, _ = _write_av2_tree(root)
    (log / "sensors" / "cameras" / "ring_front_left" /
     "notatimestamp.jpg").write_bytes(b"x")
    return {}


def _microsecond_stamps(root):
    log, _ = _write_av2_tree(root, sweeps=2)
    for cam in CAMS:
        d = log / "sensors" / "cameras" / cam
        for f in sorted(d.glob("*.jpg")):
            f.rename(d / f"{int(f.stem) + 50_000_000}.jpg")
    return {}


def _bev_wrong_shape_and_range(root):
    _, bev = _write_av2_tree(root, sweeps=2)
    files = sorted(bev.glob("*.npz"))
    np.savez_compressed(files[0], np.zeros((128, 128, 7), np.uint8))
    np.savez_compressed(files[1], np.full((256, 256, 7), 3.0, np.float32))
    return {"deep": "true"}


def _bev_stamps_mismatch(root):
    _, bev = _write_av2_tree(root, sweeps=2)
    for f in bev.glob("*.npz"):
        f.rename(bev / f"{int(f.stem) + 7}.npz")
    return {}


def _missing_camera_dir(root):
    log, _ = _write_av2_tree(root)
    shutil.rmtree(log / "sensors" / "cameras" / "ring_front_right")
    return {}


def _orientation_and_size_mismatch(root):
    import cv2
    log, _ = _write_av2_tree(root)
    for f in (log / "sensors" / "cameras" / "ring_front_center").glob("*.jpg"):
        cv2.imwrite(str(f), np.zeros((48, 64, 3), np.uint8))
    return {"deep": "true"}


def _nuscenes(root, deep=False):
    version = _write_nuscenes_fixture(root)
    return {"dataset": "nuscenes", "version": version,
            "deep": "true" if deep else "false"}


def _nuscenes_missing_table_and_keys(root):
    args = _nuscenes(root)
    tdir = root / args["version"]
    (tdir / "ego_pose.json").unlink()
    rows = json.loads((tdir / "sample_data.json").read_text())
    for r in rows:
        r.pop("is_key_frame")
    (tdir / "sample_data.json").write_text(json.dumps(rows))
    return args


def _nuscenes_incomplete_keyframes(root):
    args = _nuscenes(root)
    tdir = root / args["version"]
    rows = json.loads((tdir / "sample_data.json").read_text())
    rows = [r for r in rows if "CAM_BACK-" not in r["token"]
            and not r["token"].endswith("CAM_BACK")]
    (tdir / "sample_data.json").write_text(json.dumps(rows))
    return args


def _nuscenes_missing_image(root):
    args = _nuscenes(root, deep=True)
    next((root / "samples" / "CAM_FRONT").glob("*.jpg")).unlink()
    return args


def _cli_sensor_removed(root):
    _write_av2_tree(root)
    shutil.rmtree(root / "sensor")
    return {}


# case -> (tree writer, a substring of an issue the case must report, or
# None for a clean tree, and the exit code)
CASES = {
    "av2_clean_deep": (lambda r: {**_clean(r), "deep": "true"}, None, 0),
    "av2_missing_calibration_column": (_missing_calibration_column,
                                       "missing columns ['fx_px']", 1),
    "av2_bad_timestamp_filename": (_bad_timestamp_filename,
                                   "not an integer nanosecond", 1),
    "av2_microsecond_stamps_break_sync": (_microsecond_stamps, "0 of 2", 1),
    "av2_bev_wrong_shape_and_range": (_bev_wrong_shape_and_range, "[0,1]", 1),
    "av2_bev_stamps_mismatch": (_bev_stamps_mismatch, "no BEV npz matches", 1),
    "av2_missing_camera_dir": (_missing_camera_dir, "camera frame dir missing",
                               1),
    "av2_orientation_and_size_mismatch_deep": (_orientation_and_size_mismatch,
                                               "landscape", 1),
    "nuscenes_clean_fixture_deep": (lambda r: _nuscenes(r, deep=True), None, 0),
    "nuscenes_missing_table_and_keys": (_nuscenes_missing_table_and_keys,
                                        "is_key_frame", 1),
    "nuscenes_incomplete_keyframes": (_nuscenes_incomplete_keyframes,
                                      "CAM_BACK", 1),
    "nuscenes_missing_image_deep": (_nuscenes_missing_image,
                                    "missing on disk", 1),
    "cli_exit_codes_sensor_removed": (_cli_sensor_removed,
                                      "sensor split dir missing", 1),
}


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return e.value.code, out[:-1], json.loads(out[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_validators_agree(case, tmp_path, capsys):
    write, finding, code = CASES[case]
    args = {"dataset": "argoverse", **write(tmp_path)}
    argv = [f"root={tmp_path}"] + [f"{k}={v}" for k, v in args.items()]
    want = _run(jvd.main, argv, capsys)
    got = _run(tvd.main, argv, capsys)
    assert got == want
    assert got[0] == code
    issues = got[1]
    if finding is None:
        assert not any(line.startswith("[ERROR]") for line in issues), issues
        assert got[2]["checked"] > 5
    else:
        assert any(finding in line for line in issues), issues


def test_unknown_argument_exits(tmp_path, capsys):
    _write_av2_tree(tmp_path)
    with pytest.raises(SystemExit, match="unknown argument"):
        tvd.main([f"root={tmp_path}", "dataset=nuscenes", "split=val"])
    with pytest.raises(SystemExit, match="root="):
        tvd.main(["dataset=argoverse"])
    with pytest.raises(SystemExit, match="unknown dataset"):
        tvd.main([f"root={tmp_path}", "dataset=waymo"])
    assert capsys.readouterr().out == ""
