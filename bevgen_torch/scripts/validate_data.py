"""Validate an Argoverse 2 or nuScenes tree against every schema assumption
the port's data readers make, with a per-file error for each.

The port's copy of `bevgen_tpu/scripts/validate_data.py`: the same checks,
the same `Issue`/`Report` classes, the same JSON summary line and exit codes.
It walks a tree and checks the feather columns, quaternion conventions,
filename stamps, sensor synchronisation (`data/sync.py`) and BEV npz shapes
that `data/argoverse.py` reads, or the relational tables, keyframe coverage
and split lists (`data/nuscenes.py:scene_split`) that `data/nuscenes.py`
reads, before a run trips over them. pandas and cv2 are imported inside the
functions that need them; it does no device work.

  python -m bevgen_torch.scripts.validate_data dataset=argoverse \\
      root=/data/av2 split=val [bev_dir=bev_seg_full_11_14] \\
      [cameras=ring_front_left,ring_front_center,ring_front_right] \\
      [max_logs=5] [deep=true]
  python -m bevgen_torch.scripts.validate_data dataset=nuscenes \\
      root=/data/nuscenes [version=v1.0-trainval] [max_samples=50] \\
      [deep=true]

`deep=true` also decodes images and loads every BEV npz (slow); the default
checks structure, schemas and sync feasibility only. The last line is one
JSON object {"dataset", "checked", "errors", "warnings"}. Exit status: 0
clean, 1 errors found. An unknown argument exits (the reference prints it
and goes on).
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from bevgen_torch.scripts import cli

ARGOVERSE_BEV_CHANNELS = 7        # preprocess.py raster stack
ARGOVERSE_BEV_HW = (256, 256)
NUSCENES_CAMERAS = ("CAM_FRONT", "CAM_BACK", "CAM_FRONT_RIGHT",
                    "CAM_FRONT_LEFT", "CAM_BACK_RIGHT", "CAM_BACK_LEFT")

INTRINSICS_COLS = ("sensor_name", "fx_px", "fy_px", "cx_px", "cy_px")
EXTRINSICS_COLS = ("sensor_name", "qw", "qx", "qy", "qz",
                   "tx_m", "ty_m", "tz_m")


@dataclass
class Issue:
    severity: str   # "error" | "warn"
    path: str       # file/dir the issue is about
    message: str    # what is wrong and what the reader expects

    def __str__(self):
        return f"[{self.severity.upper()}] {self.path}: {self.message}"


class Report:
    def __init__(self, verbose: bool = True):
        self.issues: List[Issue] = []
        self.checked = 0
        self.verbose = verbose

    def error(self, path, msg):
        self._add("error", path, msg)

    def warn(self, path, msg):
        self._add("warn", path, msg)

    def _add(self, sev, path, msg):
        issue = Issue(sev, str(path), msg)
        self.issues.append(issue)
        if self.verbose:
            print(str(issue))

    @property
    def errors(self):
        return [i for i in self.issues if i.severity == "error"]

    def summary(self) -> dict:
        return {"checked": self.checked,
                "errors": len(self.errors),
                "warnings": len(self.issues) - len(self.errors)}


# ---------------------------------------------------------------------------
# Argoverse 2
# ---------------------------------------------------------------------------


def _check_feather(rep: Report, path: Path, required: Sequence[str]):
    """Readable feather with the required columns; returns the frame or
    None (every missing column is an error with the reader that needs
    it)."""
    import pandas as pd
    if not path.exists():
        rep.error(path, "missing calibration feather — "
                  "data/argoverse.py:load_calibration reads it per log")
        return None
    try:
        df = pd.read_feather(path)
    except Exception as e:  # noqa: BLE001 — report, don't crash the walk
        rep.error(path, f"unreadable feather ({e})")
        return None
    missing = [c for c in required if c not in df.columns]
    if missing:
        rep.error(path, f"missing columns {missing} (has "
                  f"{sorted(df.columns)}) — load_calibration indexes "
                  "rows by these names")
        return None
    rep.checked += 1
    return df


def _check_ts_names(rep: Report, d: Path, suffix: str) -> List[int]:
    """Every file in d must be <int_ns>.<suffix>; returns parsed stamps."""
    out = []
    for f in sorted(d.glob(f"*{suffix}")):
        try:
            out.append(int(f.stem))
        except ValueError:
            rep.error(f, f"filename stem is not an integer nanosecond "
                      f"timestamp — sync.build_sensor_records does "
                      f"int(stem) and will raise")
    stray = [f.name for f in d.iterdir()
             if f.is_file() and not f.name.endswith(suffix)]
    if stray:
        rep.warn(d, f"non-{suffix} files ignored by the reader: "
                 f"{stray[:5]}{'...' if len(stray) > 5 else ''}")
    return out


def validate_argoverse(root: str, split: str = "val",
                       bev_dir: str = "bev_seg_full_11_14",
                       cameras: Optional[Sequence[str]] = None,
                       max_logs: Optional[int] = None,
                       deep: bool = False,
                       rep: Optional[Report] = None) -> Report:
    from bevgen_torch.data import sync

    rep = rep or Report()
    root = Path(root)
    cameras = list(cameras or ("ring_front_left", "ring_front_center",
                               "ring_front_right"))
    sensor_dir = root / "sensor" / split
    bev_split = root / bev_dir / split
    if not sensor_dir.exists():
        rep.error(sensor_dir, "sensor split dir missing — expected "
                  "<root>/sensor/<split>/<log_id>/... (AV2 sensor layout)")
        return rep
    logs = sorted(p for p in sensor_dir.iterdir() if p.is_dir())
    if not logs:
        rep.error(sensor_dir, "no log directories")
        return rep
    if not bev_split.exists():
        rep.error(bev_split, f"BEV raster split dir missing — "
                  f"pre-generate with scripts/preprocess.py (bev_dir="
                  f"{bev_dir}); without it every sample is filtered out")
    if max_logs:
        logs = logs[:max_logs]

    for log in logs:
        log_id = log.name
        # --- calibration ---
        intr = _check_feather(rep, log / "calibration" / "intrinsics.feather",
                              INTRINSICS_COLS)
        extr = _check_feather(
            rep, log / "calibration" / "egovehicle_SE3_sensor.feather",
            EXTRINSICS_COLS)
        if intr is not None:
            for c in ("width_px", "height_px"):
                if c not in intr.columns:
                    rep.warn(log / "calibration" / "intrinsics.feather",
                             f"no {c} column — image-size cross-checks "
                             "unavailable (reader tolerates this)")
            have = set(intr["sensor_name"])
            for cam in cameras:
                if cam not in have:
                    rep.error(log / "calibration" / "intrinsics.feather",
                              f"camera {cam!r} has no intrinsics row "
                              f"(rows: {sorted(have)})")
            bad_f = intr[(intr.get("fx_px", 0) <= 0) |
                         (intr.get("fy_px", 0) <= 0)]
            for _, r in bad_f.iterrows():
                rep.error(log / "calibration" / "intrinsics.feather",
                          f"{r['sensor_name']}: non-positive focal "
                          f"fx={r['fx_px']} fy={r['fy_px']}")
        if extr is not None:
            have = set(extr["sensor_name"])
            for cam in cameras:
                if cam not in have:
                    rep.error(
                        log / "calibration" / "egovehicle_SE3_sensor.feather",
                        f"camera {cam!r} has no extrinsics row")
            q = extr[["qw", "qx", "qy", "qz"]].to_numpy(float)
            norms = np.linalg.norm(q, axis=1)
            for name, n in zip(extr["sensor_name"], norms):
                if not (0.99 < n < 1.01):
                    rep.warn(
                        log / "calibration" / "egovehicle_SE3_sensor.feather",
                        f"{name}: quaternion norm {n:.4f} != 1 (reader "
                        "re-normalizes, but this usually means a column "
                        "convention mismatch — AV2 stores scalar-first "
                        "w,x,y,z)")

        # --- sensor files ---
        cam_ts = {}
        for cam in cameras:
            d = log / "sensors" / "cameras" / cam
            if not d.exists():
                rep.error(d, "camera frame dir missing — this log yields "
                          "no multi_camera samples for the requested rig")
                continue
            cam_ts[cam] = _check_ts_names(rep, d, ".jpg")
            if not cam_ts[cam]:
                rep.error(d, "no .jpg frames")
        lidar_dir = log / "sensors" / "lidar"
        lidar_ts = (_check_ts_names(rep, lidar_dir, ".feather")
                    if lidar_dir.exists() else [])
        if not lidar_ts:
            rep.error(lidar_dir, "no lidar sweeps — lidar is the sync "
                      "reference sensor; this log yields no samples")

        # --- sync feasibility (the actual reader path, in-memory) ---
        if lidar_ts and all(cam_ts.get(c) for c in cameras):
            files = [lidar_dir / f"{t}.feather" for t in lidar_ts]
            for cam in cameras:
                files += [log / "sensors" / "cameras" / cam / f"{t}.jpg"
                          for t in cam_ts[cam]]
            records = sync.build_sensor_records(files, split)
            table = sync.filter_complete(
                sync.synchronize(records, "lidar", cameras), cameras)
            rep.checked += 1
            if len(table) == 0:
                rep.error(log, f"0 of {len(lidar_ts)} lidar sweeps have "
                          f"all {len(cameras)} cameras within "
                          f"{sync.MAX_MATCH_OFFSET_NS / 1e6:.0f} ms — "
                          "check that filenames are nanosecond (not "
                          "microsecond/second) stamps")
            elif len(table) < 0.5 * len(lidar_ts):
                rep.warn(log, f"only {len(table)}/{len(lidar_ts)} sweeps "
                         "synchronize with a complete rig")
            # --- BEV rasters are keyed by EXACT lidar timestamp ---
            bev_log = bev_split / log_id
            if bev_log.exists():
                have_npz = {int(p.stem) for p in bev_log.glob("*.npz")
                            if p.stem.isdigit()}
                matched = sum(int(t) in have_npz
                              for t in table["timestamp_ns"])
                if matched == 0 and len(table):
                    rep.error(bev_log, "no BEV npz matches any "
                              "synchronized lidar timestamp — rasters "
                              "must be named <lidar_ts>.npz (exact "
                              "stamp, argoverse.py keys by it)")
                rep.checked += 1
            else:
                rep.warn(bev_log, "no BEV raster dir for this log — its "
                         "samples are filtered out")

        if deep:
            _deep_argoverse(rep, log, bev_split / log_id, cameras, cam_ts,
                            intr)
    return rep


def _deep_argoverse(rep: Report, log: Path, bev_log: Path,
                    cameras, cam_ts, intr):
    """Decode one frame per camera + load every BEV npz."""
    import cv2
    for cam in cameras:
        ts = (cam_ts.get(cam) or [None])[0]
        if ts is None:
            continue
        f = log / "sensors" / "cameras" / cam / f"{ts}.jpg"
        img = cv2.imread(str(f))
        if img is None:
            rep.error(f, "cv2 cannot decode")
            continue
        rep.checked += 1
        h, w = img.shape[:2]
        portrait = h > w
        if cam == "ring_front_center" and not portrait:
            rep.warn(f, f"ring_front_center is {w}x{h} landscape — the "
                     "reader assumes the AV2 portrait orientation "
                     "(2048 rows x 1550 cols) for its square crop")
        if cam != "ring_front_center" and portrait:
            rep.warn(f, f"{cam} is portrait {w}x{h} — reader expects "
                     "landscape ring cameras")
        if intr is not None and "width_px" in intr.columns:
            row = intr[intr.sensor_name == cam]
            if len(row) and (int(row.iloc[0]["width_px"]) != w
                             or int(row.iloc[0]["height_px"]) != h):
                rep.error(f, f"image {w}x{h} != calibration "
                          f"{int(row.iloc[0]['width_px'])}x"
                          f"{int(row.iloc[0]['height_px'])} — intrinsics "
                          "would be applied at the wrong scale")
    if bev_log.exists():
        for f in sorted(bev_log.glob("*.npz")):
            try:
                with np.load(f) as z:
                    arr = next(iter(z.values()))
            except Exception as e:  # noqa: BLE001
                rep.error(f, f"unreadable npz ({e})")
                continue
            rep.checked += 1
            if arr.ndim != 3 or arr.shape[:2] != ARGOVERSE_BEV_HW:
                rep.error(f, f"raster shape {arr.shape} — reader expects "
                          f"{ARGOVERSE_BEV_HW + (ARGOVERSE_BEV_CHANNELS,)}")
            elif arr.shape[2] != ARGOVERSE_BEV_CHANNELS:
                rep.error(f, f"{arr.shape[2]} channels != "
                          f"{ARGOVERSE_BEV_CHANNELS} (veh, large_veh, "
                          "ped, other, drivable, lane_lines, stop+xing)")
            a = np.asarray(arr, np.float32)
            if not np.isfinite(a).all():
                rep.error(f, "non-finite values in raster")
            elif a.min() < 0 or a.max() > 1:
                rep.error(f, f"values outside [0,1] (min {a.min():.3g} "
                          f"max {a.max():.3g}) — expected binary masks")


# ---------------------------------------------------------------------------
# nuScenes
# ---------------------------------------------------------------------------

_NUSC_REQUIRED_KEYS = {
    "scene": ("token", "name"),
    "sample": ("token", "scene_token", "timestamp"),
    "sample_data": ("token", "sample_token", "calibrated_sensor_token",
                    "ego_pose_token", "filename", "is_key_frame"),
    "calibrated_sensor": ("token", "sensor_token", "rotation",
                          "translation"),
    "sensor": ("token", "channel"),
    "ego_pose": ("token", "rotation", "translation"),
    "sample_annotation": ("token", "sample_token", "instance_token",
                          "translation", "size", "rotation"),
    "instance": ("token", "category_token"),
    "category": ("token", "name"),
}


def validate_nuscenes(root: str, version: str = "v1.0-trainval",
                      max_samples: Optional[int] = None,
                      deep: bool = False,
                      rep: Optional[Report] = None) -> Report:
    from bevgen_torch.data.nuscenes import scene_split

    rep = rep or Report()
    root = Path(root)
    tdir = root / version
    if not tdir.exists():
        rep.error(tdir, "version dir missing — expected "
                  "<root>/<version>/{scene,sample,...}.json")
        return rep

    tables = {}
    for name, req in _NUSC_REQUIRED_KEYS.items():
        path = tdir / f"{name}.json"
        if not path.exists():
            sev = rep.warn if name == "sample_annotation" else rep.error
            sev(path, "table missing")
            tables[name] = []
            continue
        try:
            rows = json.loads(path.read_text())
        except Exception as e:  # noqa: BLE001
            rep.error(path, f"invalid JSON ({e})")
            tables[name] = []
            continue
        if not isinstance(rows, list):
            rep.error(path, f"top level is {type(rows).__name__}, "
                      "expected a list of row dicts")
            tables[name] = []
            continue
        rep.checked += 1
        missing = [k for k in req if rows and k not in rows[0]]
        if missing:
            rep.error(path, f"rows lack required keys {missing}")
        tables[name] = rows

    if not tables.get("sample"):
        return rep

    # quaternion convention: nuScenes is scalar-first [w,x,y,z] unit
    for name in ("calibrated_sensor", "ego_pose"):
        for r in tables[name][:200]:
            q = np.asarray(r.get("rotation", []), float)
            if q.shape != (4,):
                rep.error(tdir / f"{name}.json",
                          f"token {r.get('token')}: rotation has shape "
                          f"{q.shape}, expected 4-vector [w,x,y,z]")
                break
            n = float(np.linalg.norm(q))
            if not (0.99 < n < 1.01):
                rep.warn(tdir / f"{name}.json",
                         f"token {r.get('token')}: quaternion norm "
                         f"{n:.4f} != 1")
                break

    # camera intrinsics present for camera sensors
    sensors = {r["token"]: r for r in tables["sensor"]}
    for r in tables["calibrated_sensor"]:
        ch = sensors.get(r.get("sensor_token"), {}).get("channel", "")
        if ch.startswith("CAM_"):
            K = np.asarray(r.get("camera_intrinsic", []), float)
            if K.shape != (3, 3):
                rep.error(tdir / "calibrated_sensor.json",
                          f"{ch} token {r['token']}: camera_intrinsic "
                          f"shape {K.shape} != (3,3)")

    # keyframe coverage: each sample must have all 6 cameras + LIDAR_TOP
    cs = {r["token"]: r for r in tables["calibrated_sensor"]}
    by_sample = {}
    for sd in tables["sample_data"]:
        if not sd.get("is_key_frame"):
            continue
        tok = cs.get(sd["calibrated_sensor_token"], {}).get("sensor_token")
        ch = sensors.get(tok, {}).get("channel")
        if ch:
            by_sample.setdefault(sd["sample_token"], {})[ch] = sd
    samples = tables["sample"]
    if max_samples:
        samples = samples[:max_samples]
    need = set(NUSCENES_CAMERAS) | {"LIDAR_TOP"}
    incomplete = 0
    for s in samples:
        have = set(by_sample.get(s["token"], {}))
        if not need <= have:
            incomplete += 1
            if incomplete <= 3:
                rep.error(tdir / "sample_data.json",
                          f"sample {s['token']}: missing keyframe "
                          f"channels {sorted(need - have)}")
    if incomplete > 3:
        rep.error(tdir / "sample_data.json",
                  f"... {incomplete} samples total lack full keyframe "
                  "coverage")
    rep.checked += 1

    # scene names vs the shipped split lists
    names = {s["name"] for s in tables["scene"]}
    for split in ("train", "val"):
        known = set(scene_split(split))
        if names and not (names & known) and version != "v1.0-mini":
            rep.warn(tdir / "scene.json",
                     f"no scene name appears in the shipped {split} "
                     "split list — split filtering would yield 0 samples")

    if deep:
        import cv2
        for s in samples[: (max_samples or 20)]:
            for ch, sd in by_sample.get(s["token"], {}).items():
                if not ch.startswith("CAM_"):
                    continue
                f = root / sd["filename"]
                if not f.exists():
                    rep.error(f, "image file referenced by sample_data "
                              "is missing on disk")
                elif cv2.imread(str(f)) is None:
                    rep.error(f, "cv2 cannot decode")
                else:
                    rep.checked += 1
    return rep


def main(argv: Optional[List[str]] = None):
    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    dataset = args.pop("dataset", "argoverse")
    root = args.pop("root", None) or args.pop("dataset_dir", None)
    if not root:
        raise SystemExit("root=<dataset dir> is required")
    deep = args.pop("deep", "false").lower() == "true"
    if dataset == "argoverse":
        cams = args.pop("cameras", None)
        kw = dict(split=args.pop("split", "val"),
                  bev_dir=args.pop("bev_dir", "bev_seg_full_11_14"),
                  cameras=cams.split(",") if cams else None,
                  max_logs=int(args.pop("max_logs", 0)) or None, deep=deep)
        validate = validate_argoverse
    elif dataset == "nuscenes":
        kw = dict(version=args.pop("version", "v1.0-trainval"),
                  max_samples=int(args.pop("max_samples", 0)) or None,
                  deep=deep)
        validate = validate_nuscenes
    else:
        raise SystemExit(f"unknown dataset {dataset!r} "
                         "(argoverse|nuscenes)")
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    rep = validate(root, **kw)
    print(json.dumps({"dataset": dataset, **rep.summary()}))
    raise SystemExit(0 if not rep.errors else 1)

if __name__ == "__main__":
    main()
