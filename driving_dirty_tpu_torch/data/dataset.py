"""Labeled scene reader for the 6-camera driving dataset
(driving_dirty_tpu/data/dataset.py). PIL and pandas are imported inside the
functions that use them, so the package imports where they are absent.

Directory layout:

    <root>/scene_<i>/sample_<j>/CAM_{FRONT_LEFT,FRONT,FRONT_RIGHT,
                                     BACK_LEFT,BACK,BACK_RIGHT}.jpeg
    <root>/scene_<i>/sample_<j>/ego.png
    <root>/annotation.csv

Items are numpy NHWC; targets are fixed-shape (boxes padded to `max_boxes`
with a validity mask). Decoding is PIL's; the native libjpeg decoder comes
later.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

NUM_SAMPLE_PER_SCENE = 126
NUM_IMAGE_PER_SAMPLE = 6
IMAGE_NAMES = [
    "CAM_FRONT_LEFT.jpeg",
    "CAM_FRONT.jpeg",
    "CAM_FRONT_RIGHT.jpeg",
    "CAM_BACK_LEFT.jpeg",
    "CAM_BACK.jpeg",
    "CAM_BACK_RIGHT.jpeg",
]
IMAGE_H, IMAGE_W = 256, 306
MAX_BOXES_DEFAULT = 100

LABELED_SCENES = np.arange(106, 134)


def _load_image(path, raw_uint8: bool = False):
    """Decode one JPEG/PNG to RGB HWC (uint8, or f32 in [0,1])."""
    from PIL import Image

    with Image.open(path) as im:
        if raw_uint8:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _load_sample_images(path, raw_uint8: bool):
    """All 6 camera views of one sample as a [6, H, W, 3] array."""
    return np.stack([_load_image(os.path.join(path, n), raw_uint8) for n in IMAGE_NAMES])


@dataclass
class LabeledDataset:
    """Labeled scenes: images + padded boxes/categories + road map.

    Item dict:
      images     [6, H, W, 3] float32 (uint8 with raw_uint8)
      boxes      [max_boxes, 2, 4] float32 (meters; rows x/y, corners fl,fr,bl,br)
      categories [max_boxes] int32 (padded with -1)
      box_valid  [max_boxes] bool
      road       [800, 800] float32 {0,1}
      action     [max_boxes] int32   (extra_info only)
      ego        [800, 800, 3]       (extra_info only)
      lane       [800, 800] float32  (extra_info only)
    """

    image_folder: str
    annotation_file: str
    scene_index: np.ndarray
    max_boxes: int = MAX_BOXES_DEFAULT
    extra_info: bool = False
    samples_per_scene: int = NUM_SAMPLE_PER_SCENE
    raw_uint8: bool = False  # camera images as uint8 (normalize on device)

    def __post_init__(self):
        import pandas as pd

        self.scene_index = np.asarray(self.scene_index)
        df = pd.read_csv(self.annotation_file)
        # grouped once on (scene, sample), not filtered per item
        self._groups = {k: v for k, v in df.groupby(["scene", "sample"])}

    def __len__(self):
        return self.scene_index.size * self.samples_per_scene

    def __getitem__(self, index):
        scene_id = int(self.scene_index[index // self.samples_per_scene])
        sample_id = index % self.samples_per_scene
        path = os.path.join(self.image_folder, f"scene_{scene_id}", f"sample_{sample_id}")
        images = _load_sample_images(path, self.raw_uint8)

        entries = self._groups.get((scene_id, sample_id))
        boxes = np.zeros((self.max_boxes, 2, 4), np.float32)
        cats = np.full((self.max_boxes,), -1, np.int32)
        valid = np.zeros((self.max_boxes,), bool)
        actions = np.full((self.max_boxes,), -1, np.int32)
        if entries is not None and len(entries):
            corners = entries[
                ["fl_x", "fr_x", "bl_x", "br_x", "fl_y", "fr_y", "bl_y", "br_y"]
            ].to_numpy(np.float32)
            n = min(len(corners), self.max_boxes)
            boxes[:n] = corners[:n].reshape(-1, 2, 4)
            cats[:n] = entries["category_id"].to_numpy(np.int32)[:n]
            valid[:n] = True
            if self.extra_info and "action_id" in entries:
                actions[:n] = entries["action_id"].to_numpy(np.int32)[:n]

        # road = not (R == G == B == 1) on the ego map (helper.py:10-20)
        ego_chw = np.transpose(_load_image(os.path.join(path, "ego.png")), (2, 0, 1))
        road = (~((ego_chw[0] == 1) & (ego_chw[1] == 1) & (ego_chw[2] == 1))).astype(np.float32)

        item = {
            "images": images,
            "boxes": boxes,
            "categories": cats,
            "box_valid": valid,
            "road": road,
        }
        if self.extra_info:
            lane_mask = (
                (ego_chw[0] == ego_chw[1]) & (ego_chw[1] == ego_chw[2])
            ) | (ego_chw[0] == 250 / 255)
            lane = (~lane_mask).astype(np.float32)
            item.update(action=actions, ego=np.transpose(ego_chw, (1, 2, 0)), lane=lane)
        return item
