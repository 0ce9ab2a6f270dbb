"""Multi-sensor synchronization cache.

The port's copy of `bevgen_tpu/data/sync.py` (same tables for the same
records), with pandas imported inside the functions that use it. Pandas
re-implementation of the reference's forked av2 sensor
dataloader synchronization (argoverse_multi_sensor_dataloader.py:
159-189, 454-508): a nearest-timestamp association of every camera to
each reference sensor record via `pd.merge_asof`, cached to feather,
then filtered to rows where ALL requested cameras matched.

Works on plain (split, log_id, sensor_name, timestamp_ns) tables so it
is testable without av2 or the dataset on disk; the glue that builds
those tables from directory listings is in bevgen_torch.data.argoverse.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# max tolerated cam<->lidar offset: the av2 RING_CAMERA_FPS is 20Hz ->
# half a frame period, matching the reference's matching criterion
CAM_NOMINAL_HZ = 20.0
MAX_MATCH_OFFSET_NS = int(0.5 * 1e9 / CAM_NOMINAL_HZ)


def build_sensor_records(files: Sequence[Path], split: str) -> pd.DataFrame:
    """File paths `<log_id>/sensors/<...>/<sensor_name>/<ts>.<ext>` ->
    records table (the reference's sensor cache,
    argoverse_multi_sensor_dataloader.py:238)."""
    import pandas as pd
    rows = []
    for f in files:
        f = Path(f)
        ts = int(f.stem)
        sensor = f.parent.name
        # .../<log_id>/sensors/cameras/<cam>/<ts>.jpg or
        # .../<log_id>/sensors/lidar/<ts>.feather
        parts = f.parts
        idx = parts.index("sensors")
        log_id = parts[idx - 1]
        rows.append((split, log_id, sensor, ts))
    df = pd.DataFrame(rows, columns=["split", "log_id", "sensor_name",
                                     "timestamp_ns"])
    return df.sort_values(
        ["split", "log_id", "sensor_name", "timestamp_ns"]).reset_index(
            drop=True)


def synchronize(records: pd.DataFrame, reference_sensor: str,
                cam_names: Sequence[str],
                tolerance_ns: int = MAX_MATCH_OFFSET_NS) -> pd.DataFrame:
    """For every `reference_sensor` record, find the nearest timestamp
    of each camera within tolerance. Returns one row per reference
    record with one column per camera (NaN when unmatched) —
    the reference's synchronization cache
    (argoverse_multi_sensor_dataloader.py:454-508)."""
    import pandas as pd
    ref = records[records.sensor_name == reference_sensor][
        ["split", "log_id", "timestamp_ns"]].copy()
    # empty / freshly-built tables can carry object dtype, which
    # merge_asof rejects with an unhelpful error
    ref["timestamp_ns"] = ref["timestamp_ns"].astype(np.int64)
    ref = ref.sort_values("timestamp_ns").reset_index(drop=True)
    out = ref.copy()
    for cam in cam_names:
        tgt = records[records.sensor_name == cam][
            ["split", "log_id", "timestamp_ns"]].copy()
        tgt["timestamp_ns"] = tgt["timestamp_ns"].astype(np.int64)
        tgt = tgt.rename(columns={"timestamp_ns": cam})
        tgt = tgt.sort_values(cam).reset_index(drop=True)
        merged = pd.merge_asof(
            ref.sort_values("timestamp_ns"),
            tgt,
            left_on="timestamp_ns", right_on=cam,
            by=["split", "log_id"],
            direction="nearest",
            tolerance=tolerance_ns,
        )
        out[cam] = merged[cam].astype("Int64")
    out = out.sort_values(["split", "log_id", "timestamp_ns"]).reset_index(
        drop=True)
    return out


def filter_complete(sync: pd.DataFrame, cam_names: Sequence[str]
                    ) -> pd.DataFrame:
    """Keep rows where every requested camera matched
    (argoverse_multi_sensor_dataloader.py:176-189)."""
    mask = np.ones(len(sync), dtype=bool)
    for cam in cam_names:
        mask &= sync[cam].notna().to_numpy()
    return sync[mask].reset_index(drop=True)


def per_frame_records(records: pd.DataFrame, cam_names: Sequence[str],
                      lidar_tolerance_ns: int = int(0.5 * 1e9 / 10.0)
                      ) -> pd.DataFrame:
    """One record per CAMERA FRAME (not per synchronized sweep), each
    matched to its nearest lidar timestamp — the reference's
    single-camera stage-1 dataset mode (`populate_image_records` +
    BEV-by-lidar-sync, bev_utils/argoverse.py:307-333,
    argoverse_helper.py:77). Trains stage 1 on ALL frames of every
    requested camera. Tolerance: half the 10 Hz lidar period."""
    import pandas as pd
    cams = records[records.sensor_name.isin(list(cam_names))][
        ["split", "log_id", "sensor_name", "timestamp_ns"]].copy()
    cams["timestamp_ns"] = cams["timestamp_ns"].astype(np.int64)
    lidar = records[records.sensor_name == "lidar"][
        ["split", "log_id", "timestamp_ns"]].copy()
    lidar["timestamp_ns"] = lidar["timestamp_ns"].astype(np.int64)
    lidar = lidar.rename(columns={"timestamp_ns": "lidar"})
    out = pd.merge_asof(
        cams.sort_values("timestamp_ns"),
        lidar.sort_values("lidar"),
        left_on="timestamp_ns", right_on="lidar",
        by=["split", "log_id"],
        direction="nearest",
        tolerance=lidar_tolerance_ns,
    )
    out = out[out["lidar"].notna()].copy()
    out["lidar"] = out["lidar"].astype(np.int64)
    return out.sort_values(
        ["split", "log_id", "sensor_name", "timestamp_ns"]).reset_index(
            drop=True)


def load_or_build_sync_cache(cache_path: Optional[Path],
                             records: pd.DataFrame, reference_sensor: str,
                             cam_names: Sequence[str]) -> pd.DataFrame:
    """Feather-cached synchronization (reference caches at
    ~/.cache/av2/<split>_sensor_cache.feather)."""
    import pandas as pd
    if cache_path is not None and Path(cache_path).exists():
        return pd.read_feather(cache_path)
    sync = synchronize(records, reference_sensor, cam_names)
    if cache_path is not None:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        sync.to_feather(cache_path)
    return sync
