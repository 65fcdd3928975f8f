"""View stitching (driving_dirty_tpu/ops/stitch.py).

Camera order on input matches the dataset order FL, F, FR, BL, B, BR; the
panorama order is FL, F, FR, BR, B, BL (index permutation [0,1,2,5,4,3]).
Images are NHWC ([..., H, W, C]); the views axis precedes H.
"""
from __future__ import annotations

import torch

PANORAMA_ORDER = (0, 1, 2, 5, 4, 3)
VIEW_W = 306
NUM_VIEWS = 6


def normalize_images(x, dtype=None):
    """uint8 images -> `dtype` (default f32) in [0, 1], divided on the tensor's
    own device (the loaders ship raw uint8: 4x fewer bytes to copy). Float
    input is only cast, when `dtype` is given. The scale 1/255 is first
    rounded to `dtype`, as JAX rounds a Python scalar to the array's type."""
    if not x.is_floating_point():
        dtype = dtype or torch.float32
        return x.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
    if dtype is not None:
        return x.to(dtype)
    return x


def wide_stitch(x):
    """[b, 6, H, W, C] -> [b, H, 6*W, C] panorama in FL,F,FR,BR,B,BL order."""
    x = x[:, list(PANORAMA_ORDER)]
    b, v, h, w, c = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, h, v * w, c)


def unstitch(pano, view_width: int = VIEW_W):
    """Inverse of wide_stitch (panorama order -> [b, 6, H, W, C] dataset order)."""
    b, h, w, c = pano.shape
    v = w // view_width
    x = pano.reshape(b, h, v, view_width, c).permute(0, 2, 1, 3, 4)
    inv = [0] * NUM_VIEWS
    for i, p in enumerate(PANORAMA_ORDER):
        inv[p] = i
    return x[:, inv]
