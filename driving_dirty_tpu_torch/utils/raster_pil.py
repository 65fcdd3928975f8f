"""The PIL rasterizer oracle (driving_dirty_tpu/utils/raster_pil.py).

The reference's box-to-map semantics, drawn by PIL's ImageDraw.polygon
fill: corners reordered to [fl, fr, br, bl], px = m * 10 + 400, the map
flipped vertically. A host-side oracle for the tests of kernel B2
(kernels/raster.py) and its plain version; nothing on the device path
imports PIL through it.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw


def boxes_to_binary_map_pil(boxes_m, size: int = 800):
    boxes = np.asarray(boxes_m, dtype=np.float64)
    data = np.zeros((size, size))
    img = Image.fromarray(data)
    draw = ImageDraw.Draw(img)
    for box in boxes:  # box: [2, 4], rows x/y, corners fl, fr, bl, br
        quad = np.stack([box[:, 0], box[:, 1], box[:, 3], box[:, 2]])  # fl, fr, br, bl
        quad = quad * 10 + 400
        draw.polygon(list(quad.flatten()), fill=1)
    out = np.asarray(img)
    return np.flip(out, 0).astype(np.float32)
