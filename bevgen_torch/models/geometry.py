"""Token-sequence and camera geometry: grids, decode-order permutation,
camera-ray directions.

Pure numpy, cached on the (hashable) MultiViewConfig. A copy of the parts
of the reference module (`bevgen_tpu/models/geometry.py`) that the port's
MUSE and AR sparse-GPT paths read (grids, the decode order with the
nuScenes outward interleave, `col_angles` for the legacy layout prior,
the canonical rig), including its deliberate quirks (the h/w swap of
`image_plane`, the swapped image size in `col_angles`).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from bevgen_torch.core.config import CAMERA_SETS, MultiViewConfig


def generate_grid(height: int, width: int) -> np.ndarray:
    """Homogeneous pixel grid, shape (3, h, w): channel 0 = x in [0,1]
    (over width), channel 1 = y in [0,1] (over height), channel 2 = 1."""
    xs = np.linspace(0.0, 1.0, width, dtype=np.float32)
    ys = np.linspace(0.0, 1.0, height, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    ones = np.ones_like(gx)
    return np.stack([gx, gy, ones], axis=0)


def image_plane(cfg: MultiViewConfig) -> np.ndarray:
    """Pixel-coordinate plane at latent resolution, shape (3, h, w).

    Reference quirk, kept for checkpoint fidelity: x is scaled by
    cam_res[0] (the image HEIGHT) and y by cam_res[1] (the WIDTH)."""
    g = generate_grid(cfg.cam_latent_h, cfg.cam_latent_w).copy()
    g[0] *= cfg.cam_res[0]
    g[1] *= cfg.cam_res[1]
    return g


def get_bev_grid(cfg: MultiViewConfig, offset: int = 0) -> np.ndarray:
    """Metric ego-frame coordinates of each BEV latent cell, (3, h, w):
    an 80 m x 80 m window through the inverse view matrix."""
    h, w = cfg.bev_latent_res
    grid = generate_grid(h, w).astype(np.float64)
    grid[0] *= w
    grid[1] *= h
    sh = h / 80.0
    sw = w / 80.0
    V = np.array([[0.0, -sw, w / 2.0],
                  [-sh, 0.0, h * offset + h / 2.0],
                  [0.0, 0.0, 1.0]])
    V_inv = np.linalg.inv(V)
    flat = grid.reshape(3, h * w)
    out = (V_inv @ flat).reshape(3, h, w)
    return out.astype(np.float32)


@lru_cache(maxsize=256)
def seq_pixel_mappings(cfg: MultiViewConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(pixel_to_seq [cam,h,w], seq_to_pixel [N,3]) in raw (cam,h,w) order."""
    cams, h, w = cfg.num_cams, cfg.cam_latent_h, cfg.cam_latent_w
    seq_to_pixel = np.stack(np.meshgrid(
        np.arange(cams), np.arange(h), np.arange(w), indexing="ij"),
        axis=-1).reshape(-1, 3)
    pixel_to_seq = np.zeros((cams, h, w), dtype=np.int64)
    pixel_to_seq[seq_to_pixel[:, 0], seq_to_pixel[:, 1], seq_to_pixel[:, 2]] = (
        np.arange(seq_to_pixel.shape[0]))
    return pixel_to_seq, seq_to_pixel


@lru_cache(maxsize=256)
def decode_order(cfg: MultiViewConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(forward_shuffle_idx, backward_shuffle_idx) — the cross-camera
    "outward" decode order.

    nuScenes: per latent row, interleave center-camera columns outward
    into the side cameras (front group, then back group).
    Other datasets: per latent row, row-major across cameras.
    causal_order=False -> identity.
    """
    pixel_to_seq, _ = seq_pixel_mappings(cfg)
    center = cfg.cam_latent_w // 2
    names = cfg.camera_names

    if not cfg.causal_order:
        fwd = np.arange(cfg.num_img_tokens, dtype=np.int64)
        return fwd, np.argsort(fwd)

    if cfg.dataset == "nuscenes" and cfg.num_cams in (3, 6):
        if cfg.num_cams == 3:
            groups = [("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT")]
            cam_index = CAMERA_SETS["NUSCENES_ABLATION_CAMERAS"]
        else:
            groups = [("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT"),
                      ("CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT")]
            cam_index = CAMERA_SETS["NUSCENES_CAMERAS"]

        indices = []
        for i in range(cfg.cam_latent_h):
            dir_idxs = []
            for l_cam, c_cam, r_cam in groups:
                head = []
                left_seq_left = pixel_to_seq[cam_index.index(l_cam), i, :].tolist()[::-1]
                right_seq_right = pixel_to_seq[cam_index.index(r_cam), i, :].tolist()
                left_seq_center = pixel_to_seq[cam_index.index(c_cam), i, :center].tolist()[::-1]
                if cfg.cam_latent_w % 2 == 0:
                    right_seq_center = pixel_to_seq[cam_index.index(c_cam), i, center:].tolist()
                else:
                    head.append(int(pixel_to_seq[cam_index.index(c_cam), i, center]))
                    right_seq_center = pixel_to_seq[cam_index.index(c_cam), i, center + 1:].tolist()
                left_chain = [*left_seq_center, *left_seq_left]
                right_chain = [*right_seq_center, *right_seq_right]
                inter = [v for pair in zip(left_chain, right_chain) for v in pair]
                dir_idxs.append([*head, *inter])
            row = [v for tup in zip(*dir_idxs) for v in tup]
            indices.extend(row)
    else:
        indices = []
        for i in range(cfg.cam_latent_h):
            for j, _cam in enumerate(names):
                indices.extend(pixel_to_seq[j, i, :].tolist())

    fwd = np.asarray(indices, dtype=np.int64)
    return fwd, np.argsort(fwd)


# Hard-coded nuScenes rig (fx, fy, yaw-angle rad CCW).
NUSCENES_CAM_DATA = {
    "CAM_FRONT": (1266.417203046554, 1266.417203046554, 0.005684811144346602),
    "CAM_BACK": (809.2209905677063, 809.2209905677063, 3.1391709219861887),
    "CAM_FRONT_RIGHT": (1260.8474446004698, 1260.8474446004698, 5.298742851167251),
    "CAM_FRONT_LEFT": (1272.5979470598488, 1272.5979470598488, 0.9627404474321728),
    "CAM_BACK_RIGHT": (1259.5137405846733, 1259.5137405846733, 4.349372983905386),
    "CAM_BACK_LEFT": (1256.7414812095406, 1256.7414812095406, 1.895431863668132),
}

# Canonical yaw angles (rad CCW, 0 = forward) of the synthetic Argoverse
# rig: the av2 ring cameras are spaced ~2pi/7 apart.
ARGOVERSE_CANONICAL_YAW = {
    "ring_front_center": 0.0,
    "ring_front_left": 2 * np.pi / 7,
    "ring_front_right": -2 * np.pi / 7,
    "ring_side_left": 2 * (2 * np.pi / 7),
    "ring_side_right": -2 * (2 * np.pi / 7),
    "ring_rear_left": 3 * (2 * np.pi / 7),
    "ring_rear_right": -3 * (2 * np.pi / 7),
}


def compute_pixel_ray_directions(uv: np.ndarray, fx: float, fy: float,
                                 img_w: float, img_h: float) -> np.ndarray:
    """Normalized camera-frame rays for pixel coords (N,2).
    +z out of camera, +y down, +x across."""
    px, py = img_w / 2.0, img_h / 2.0
    u, v = uv[:, 0], uv[:, 1]
    rays = np.stack([u - px, v - py, np.full_like(u, fx)], axis=1)
    return rays / np.linalg.norm(rays, axis=1, keepdims=True)


@lru_cache(maxsize=64)
def col_angles(cfg: MultiViewConfig) -> np.ndarray:
    """Per-(camera, latent-column) viewing angle in [0, 2pi), shape
    (6, cam_latent_w), over the 6 nuScenes cameras (legacy bias path).
    Keeps the reference's swapped img_w/img_h argument order."""
    names = CAMERA_SETS["NUSCENES_CAMERAS"]
    img_w, img_h = 1600.0, 900.0
    out = []
    for cam_name in names:
        fx, fy, cam_angle = NUSCENES_CAM_DATA[cam_name]
        cols = []
        for i in range(cfg.cam_latent_w):
            uv = np.array([[img_w * ((i + 0.5) / cfg.cam_latent_w), img_h / 2.0]])
            ray = compute_pixel_ray_directions(uv, fx, fy, img_h, img_w)[0, 0]
            cols.append(np.mod(cam_angle + (-ray), 2 * np.pi).astype(np.float32))
        out.append(cols)
    return np.asarray(out, dtype=np.float32)


def canonical_camera_rig(cfg: MultiViewConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (intrinsics [cam,3,3], extrinsics [cam,4,4]) rig for
    the configured camera set.

    Convention per dataset, as in the reference batch dict: Argoverse
    stores `ego_SE3_cam` (cam->ego); nuScenes stores `cam_from_ego`.
    Camera axes +z forward, +x right, +y down."""
    names = cfg.camera_names
    n = len(names)
    intr = np.zeros((n, 3, 3), dtype=np.float64)
    extr = np.zeros((n, 4, 4), dtype=np.float64)
    img_w, img_h = 1600.0, 900.0
    for i, name in enumerate(names):
        if name in NUSCENES_CAM_DATA:
            fx, fy, yaw = NUSCENES_CAM_DATA[name]
        else:
            yaw = ARGOVERSE_CANONICAL_YAW.get(name, 0.0)
            hfov = 2 * np.pi / 7  # ring cameras tile the full circle
            fx = fy = (img_w / 2.0) / np.tan(hfov / 2.0)
        intr[i] = [[fx, 0, img_w / 2.0], [0, fy, img_h / 2.0], [0, 0, 1]]
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[s, 0.0, c],
                      [-c, 0.0, s],
                      [0.0, -1.0, 0.0]])
        E = np.eye(4)
        E[:3, :3] = R
        extr[i] = E
    if cfg.dataset == "nuscenes":
        extr = np.linalg.inv(extr)
    return intr, extr


def _read_rig_file(path: str):
    """Read a measured-rig artifact (a torch `.pt` batch dict or an npz)
    and return batch row 0's (intrinsics (cam,3,3), extrinsics (cam,4,4))."""
    if path.endswith((".pt", ".pth", ".ckpt")):
        import torch
        data = torch.load(path, map_location="cpu", weights_only=False)
    else:
        data = np.load(path)
    intr = np.asarray(data["intrinsics"], np.float64)
    extr = np.asarray(data["extrinsics"], np.float64)
    if intr.ndim == 4:
        intr, extr = intr[0], extr[0]
    return intr, extr


@lru_cache(maxsize=16)
def load_rig(cfg: MultiViewConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The rig the bias artifacts are built from: the measured artifact at
    cfg.rig_path if set, else the canonical synthetic rig. Measured
    artifacts are stored in dataset camera order and are reordered here."""
    if cfg.rig_path is None:
        return canonical_camera_rig(cfg)
    intr, extr = _read_rig_file(cfg.rig_path)
    stored = (CAMERA_SETS["NUSCENES_CAMERAS"] if cfg.dataset == "nuscenes"
              else cfg.camera_names)
    if len(intr) != len(stored):
        raise ValueError(
            f"rig file {cfg.rig_path} has {len(intr)} cameras, expected "
            f"{len(stored)} ({stored})")
    idx = [stored.index(n) for n in cfg.camera_names]
    return intr[idx].copy(), extr[idx].copy()


@lru_cache(maxsize=64)
def image_direction_vectors(cfg: MultiViewConfig) -> np.ndarray:
    """Unit ego-frame ray direction for every image token,
    shape (num_img_tokens, 3), raw (cam,h,w) order."""
    intr, extr = load_rig(cfg)
    I_inv = np.linalg.inv(intr)
    E_inv = np.linalg.inv(extr)

    plane = generate_grid(cfg.cam_latent_h, cfg.cam_latent_w).astype(np.float64)
    plane = plane.copy()
    plane[0] *= 1600.0                     # the reference uses nuScenes image dims
    plane[1] *= 900.0
    flat = plane.reshape(3, -1)

    cam_pts = I_inv @ flat                                     # (cam,3,hw)
    cam_pts = np.concatenate(
        [cam_pts, np.ones((cfg.num_cams, 1, flat.shape[1]))], axis=1)
    d = E_inv @ cam_pts                                        # (cam,4,hw)
    c = E_inv[:, :, -1:]                                       # (cam,4,1)
    out = (d - c)[:, :3, :]                                    # (cam,3,hw)
    out = np.transpose(out, (0, 2, 1)).reshape(-1, 3)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)
