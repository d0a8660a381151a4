"""Host-side (numpy/PIL) data transforms.  The port's own copy of
``fbbev_tpu/data/transforms.py``; PIL is imported by the functions that
use it, so the module imports without it.

Parity references (``mmdet3d/datasets/pipelines/loading.py``):

* image aug + accumulated homography: ``PrepareImageInputs`` (:988-1315) --
  resize/crop/flip/rotate on the image, with the same ops accumulated into
  a 3x3 ``post_rot``/``post_tran`` so the model can undo them.
* BDA (BEV-plane) augmentation: ``LoadAnnotationsBEVDepth`` (:1316-1400).
* LiDAR depth rasterisation: ``PointToMultiViewDepth`` (:877-960).
* Occ3D GT loading + axis conversion: ``LoadOccupancy`` (:147-230).

These run on the host data-path (CPU workers), producing fixed-shape
numpy arrays for device transfer; nothing here touches the device.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fbbev_tpu_torch.geometry import quat_to_rot

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _rot2d(h: float) -> np.ndarray:
    # the BEVDet convention: [[cos, sin], [-sin, cos]]
    return np.array([[math.cos(h), math.sin(h)],
                     [-math.sin(h), math.cos(h)]], np.float32)


def sample_image_augmentation(data_config: Dict, H: int, W: int,
                              is_train: bool,
                              rng: Optional[np.random.RandomState] = None,
                              flip: Optional[bool] = None,
                              scale: Optional[float] = None):
    """Sample (resize, resize_dims, crop, flip, rotate) for one camera."""
    rng = rng or np.random
    fH, fW = data_config["input_size"]
    if is_train:
        resize = float(fW) / float(W)
        resize += rng.uniform(*data_config["resize"])
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*data_config["crop_h"])) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(data_config["flip"]) and bool(rng.choice([0, 1]))
        rotate = rng.uniform(*data_config["rot"])
    else:
        resize = float(fW) / float(W) + data_config.get("resize_test", 0.0)
        if scale is not None:
            resize = scale
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(data_config["crop_h"])) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False if flip is None else flip
        rotate = 0.0
    return resize, resize_dims, crop, flip, rotate


def update_post_homography(post_rot: np.ndarray, post_tran: np.ndarray,
                           resize: float, crop, flip: bool, rotate: float):
    """Accumulate an image aug step into the 2x2+2 post transform."""
    post_rot = post_rot * resize
    post_tran = post_tran - np.array(crop[:2], np.float32)
    if flip:
        A = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = _rot2d(rotate / 180.0 * math.pi)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2.0
    b = A @ (-b) + b
    return A @ post_rot, A @ post_tran + b


def apply_image_transform(img, resize_dims, crop, flip: bool, rotate: float):
    """PIL image pipeline: resize -> crop -> flip -> rotate."""
    from PIL import Image
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)
    return img


def normalize_image(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> normalised float32, channels last."""
    return (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def sample_bda_augmentation(bda_aug_conf: Dict, is_train: bool,
                            rng: Optional[np.random.RandomState] = None,
                            tta_config: Optional[Dict] = None):
    """BEV-aug sampling; at eval a ``tta_config`` forces the flip pair
    (``LoadAnnotationsBEVDepth.sample_bda_augmentation``,
    ``loading.py:1323-1340``)."""
    rng = rng or np.random
    if is_train:
        rotate_bda = rng.uniform(*bda_aug_conf["rot_lim"])
        scale_bda = rng.uniform(*bda_aug_conf["scale_lim"])
        flip_dx = rng.uniform() < bda_aug_conf["flip_dx_ratio"]
        flip_dy = rng.uniform() < bda_aug_conf["flip_dy_ratio"]
    else:
        rotate_bda, scale_bda, flip_dx, flip_dy = 0.0, 1.0, False, False
        if tta_config is not None:
            flip_dx = bool(tta_config.get("flip_dx", False))
            flip_dy = bool(tta_config.get("flip_dy", False))
    return rotate_bda, scale_bda, flip_dx, flip_dy


def bda_matrix(rotate_bda: float, scale_bda: float, flip_dx: bool,
               flip_dy: bool) -> np.ndarray:
    """3x3 BDA rotation: flip @ scale @ rot_z (LoadAnnotationsBEVDepth)."""
    ang = rotate_bda / 180.0 * math.pi
    s, c = math.sin(ang), math.cos(ang)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scale = np.diag([scale_bda, scale_bda, scale_bda]).astype(np.float32)
    flip = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    if flip_dy:
        flip = flip @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    return flip @ (scale @ rot)


def transform_boxes_bda(boxes: np.ndarray, rotate_bda: float,
                        scale_bda: float, flip_dx: bool,
                        flip_dy: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Apply BDA to (N, 9) boxes [x,y,z,dx,dy,dz,yaw,vx,vy]."""
    rot_mat = bda_matrix(rotate_bda, scale_bda, flip_dx, flip_dy)
    boxes = boxes.copy()
    ang = rotate_bda / 180.0 * math.pi
    if boxes.shape[0] > 0:
        boxes[:, :3] = boxes[:, :3] @ rot_mat.T
        boxes[:, 3:6] *= scale_bda
        boxes[:, 6] += ang
        if flip_dx:
            boxes[:, 6] = math.pi - boxes[:, 6]
        if flip_dy:
            boxes[:, 6] = -boxes[:, 6]
        if boxes.shape[1] > 7:
            boxes[:, 7:9] = boxes[:, 7:9] @ rot_mat[:2, :2].T
    return boxes, rot_mat


def occupancy_to_bevdet_axes(occ: np.ndarray) -> np.ndarray:
    """Occ3D (X, Y, Z) -> BEVDet training axes (LoadOccupancy:197-200):
    permute to (Z, X, Y), rot90(+1) in the (X, Y) plane, flip axis 1,
    back to spatial-first."""
    occ = np.transpose(occ, (2, 0, 1))
    occ = np.rot90(occ, 1, (1, 2))
    occ = np.flip(occ, 1)
    return np.transpose(occ, (1, 2, 0)).copy()


def occupancy_from_bevdet_axes(occ: np.ndarray) -> np.ndarray:
    """Inverse of :func:`occupancy_to_bevdet_axes` (the label-volume analog
    of the prediction conversion in ``fbocc.py:546-549``)."""
    occ = np.transpose(occ, (2, 0, 1))
    occ = np.flip(occ, 1)
    occ = np.rot90(occ, -1, (1, 2))
    return np.transpose(occ, (1, 2, 0)).copy()


def load_occupancy_gt(occupancy_path: str, scene_name: str,
                      sample_token: str, rotate_bda: float = 0.0,
                      flip_dx: bool = False, flip_dy: bool = False,
                      ignore_nonvisible: bool = True,
                      fix_void: bool = True) -> Dict[str, np.ndarray]:
    """Load Occ3D labels.npz and convert to training GT."""
    path = os.path.join(occupancy_path, scene_name, sample_token,
                        "labels.npz")
    data = np.load(path)
    occ = data["semantics"].astype(np.int32)
    visible = data["mask_camera"].astype(bool)
    return prepare_occupancy_gt(occ, visible, rotate_bda, flip_dx, flip_dy,
                                ignore_nonvisible, fix_void)


def prepare_occupancy_gt(occ: np.ndarray, visible: np.ndarray,
                         rotate_bda: float = 0.0, flip_dx: bool = False,
                         flip_dy: bool = False,
                         ignore_nonvisible: bool = True,
                         fix_void: bool = True) -> Dict[str, np.ndarray]:
    raw = occ
    occ = occ.copy()
    if ignore_nonvisible:
        occ[~visible] = 255
    occ = occupancy_to_bevdet_axes(occ)
    if fix_void:
        occ[occ < 255] += 1
    if rotate_bda != 0.0:
        occ = _rotate_occ(occ, -rotate_bda)
    if flip_dx:
        occ = np.flip(occ, 1).copy()
    if flip_dy:
        occ = np.flip(occ, 0).copy()
    # eval-frame GT/mask: the Occ3D frame of the *augmented world* so that
    # TTA-flip variants evaluate coherently (predictions are converted with
    # the fixed fbocc.py:546-549 transform and never un-flipped; GT and
    # camera mask must carry the same flips).  Without flips this is the
    # raw Occ3D volume exactly (round-trip tested).
    if flip_dx or flip_dy:
        vis_b = occupancy_to_bevdet_axes(visible)
        cvpr_b = occupancy_to_bevdet_axes(raw)
        for flipped, ax in ((flip_dx, 1), (flip_dy, 0)):
            if flipped:
                vis_b = np.flip(vis_b, ax)
                cvpr_b = np.flip(cvpr_b, ax)
        visible_out = occupancy_from_bevdet_axes(vis_b)
        cvpr_out = occupancy_from_bevdet_axes(cvpr_b)
    else:
        visible_out, cvpr_out = visible, raw
    return {"gt_occupancy": occ.astype(np.int32),
            "visible_mask": visible_out,
            "gt_occupancy_cvpr": cvpr_out}


def _rotate_occ(occ: np.ndarray, angle_deg: float) -> np.ndarray:
    """Nearest-neighbour rotation of the (H, W, Z) label volume about the
    BEV centre, fill=255 (torchvision ``rotate`` semantics on label maps)."""
    from PIL import Image
    out = np.empty_like(occ)
    for z in range(occ.shape[2]):
        sl = Image.fromarray(occ[:, :, z].astype(np.int32), mode="I")
        sl = sl.rotate(angle_deg, resample=Image.NEAREST, fillcolor=255)
        out[:, :, z] = np.asarray(sl, np.int32)
    return out


def points_to_depth_map(points_img: np.ndarray, height: int, width: int,
                        depth_bounds: Sequence[float],
                        downsample: int = 1) -> np.ndarray:
    """Z-buffered min-depth rasterisation (points2depthmap:883-907).

    Args:
      points_img: (P, 3) augmented pixel coords + metric depth.
    """
    height, width = height // downsample, width // downsample
    depth_map = np.zeros((height, width), np.float32)
    coor = np.round(points_img[:, :2] / downsample)
    depth = points_img[:, 2]
    kept = (
        (coor[:, 0] >= 0) & (coor[:, 0] < width)
        & (coor[:, 1] >= 0) & (coor[:, 1] < height)
        & (depth < depth_bounds[1]) & (depth >= depth_bounds[0])
    )
    coor, depth = coor[kept], depth[kept]
    ranks = coor[:, 0] + coor[:, 1] * width
    order = np.argsort(ranks + depth / 100.0, kind="stable")
    coor, depth, ranks = coor[order], depth[order], ranks[order]
    keep_first = np.ones(coor.shape[0], bool)
    keep_first[1:] = ranks[1:] != ranks[:-1]
    coor, depth = coor[keep_first].astype(np.int64), depth[keep_first]
    depth_map[coor[:, 1], coor[:, 0]] = depth
    return depth_map


# ---------------------------------------------------------------------------
# SE(3) helpers over nuScenes info dicts
# ---------------------------------------------------------------------------

def _pose(rot_quat, tran) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(np.asarray(rot_quat))
    m[:3, 3] = np.asarray(tran)
    return m


def nuscenes_rt_matrix(src_info: Dict, dest_info: Dict, src_mod: str,
                       dest_mod: str) -> np.ndarray:
    """4x4 src-frame -> dest-frame transform (datasets/utils.py:150-243).

    Modes: ``global`` / ``ego`` / ``lidar`` / ``CAM_<NAME>`` (camera xyz
    coords) / ``CAM_<NAME>_XYD`` (homogeneous pixel coords scaled by depth,
    i.e. the intrinsics are folded in; cf. utils.py:151-155).  Composition
    is always src->global->dest, exactly as the reference.
    """
    def to_global(info, mod):
        ego2global = _pose(info["ego2global_rotation"],
                           info["ego2global_translation"])
        if mod == "global":
            return np.eye(4)
        if mod == "ego":
            return ego2global
        lidar2ego = _pose(info["lidar2ego_rotation"],
                          info["lidar2ego_translation"])
        if mod == "lidar":
            return ego2global @ lidar2ego
        if mod.startswith("CAM"):
            cam = info["cams"][mod.replace("_XYD", "")]
            cam2lidar = np.eye(4)
            cam2lidar[:3, :3] = np.asarray(cam["sensor2lidar_rotation"])
            cam2lidar[:3, 3] = np.asarray(cam["sensor2lidar_translation"])
            m = ego2global @ lidar2ego @ cam2lidar
            if mod.endswith("_XYD"):
                intr = np.eye(4)
                intr[:3, :3] = np.asarray(cam["cam_intrinsic"])
                m = m @ np.linalg.inv(intr)
            return m
        raise ValueError(mod)

    return np.linalg.inv(to_global(dest_info, dest_mod)) @ \
        to_global(src_info, src_mod)


def sensor2keyego(cam_info: Dict, key_info: Dict, cam_name: str,
                  ego_cam: str = "CAM_FRONT") -> np.ndarray:
    """sweep-sensor -> key-ego 4x4 (PrepareImageInputs:1091-1160): the
    key-ego frame is anchored at the ``ego_cam`` timestamp."""
    cams = cam_info["cams"][cam_name]
    sweepsensor2sweepego = _pose(cams["sensor2ego_rotation"],
                                 cams["sensor2ego_translation"])
    sweepego2global = _pose(cams["ego2global_rotation"],
                            cams["ego2global_translation"])
    keyego2global = _pose(key_info["cams"][ego_cam]["ego2global_rotation"],
                          key_info["cams"][ego_cam]["ego2global_translation"])
    return np.linalg.inv(keyego2global) @ sweepego2global @ \
        sweepsensor2sweepego
