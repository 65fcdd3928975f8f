"""BEV map conversions, the plain box rasterizer and the detection
family's square view layout (driving_dirty_tpu/ops/maps.py).

`boxes_to_binary_map` is the plain PyTorch version of kernel B2
(kernels/raster.py, csrc/raster.cu): the CPU path of the wrapper and the
yardstick the kernel is held to, bit for bit, on the card. Every rounding
step is written out so that the kernel can repeat it exactly.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MAP_SIZE = 800
RING = (0, 1, 3, 2)  # corner order fl, fr, bl, br -> the convex ring fl, fr, br, bl


def convert_map_to_road_map(ego_map):
    """[3, H, W] (CHW, floats in [0,1]) -> [H, W] bool; road = NOT pure-white."""
    mask = (ego_map[0] == 1) & (ego_map[1] == 1) & (ego_map[2] == 1)
    return ~mask


def convert_map_to_lane_map(ego_map, binary_lane: bool = True):
    """Lane mask = NOT (grayscale or 250/255-valued) pixels; the two tests are
    OR-ed, as the reference's `+` on bools does."""
    mask = ((ego_map[0] == ego_map[1]) & (ego_map[1] == ego_map[2])) | (ego_map[0] == 250 / 255)
    if binary_lane:
        return ~mask
    return ego_map * (~mask)[None]


def raster_geometry(size: int) -> tuple[float, float]:
    """(scale, offset) from meters to pixels: px = m * scale + offset, the
    reference's m * 10 + 400 at 800 px, the same (-40, 40) m field of view at
    any other size. Both are applied in float32."""
    return size * 10.0 / MAP_SIZE, size / 2.0


def boxes_to_binary_map(boxes_m, valid=None, size: int = MAP_SIZE):
    """Rasterize [..., N, 2, 4] meter-space boxes (rows x/y, corners
    fl, fr, bl, br) into [..., size, size] {0,1} float32 maps.

    A pixel (col, pre-flip row) is inside a box when all four signed edge
    tests against the ring fl, fr, br, bl are >= 0, the sign taken from the
    ring's orientation; rows are flipped at the end. Degenerate boxes
    (|2 * area| <= 1e-6, e.g. zero padding) and boxes whose `valid` [..., N]
    is False add nothing.

    Loops over boxes and computes each box for the whole batch at once, so
    memory stays at one [..., size, size] map, not an [N, size, size] stack."""
    if size < 1:
        raise ValueError(f"raster size must be >= 1, got {size}")
    boxes_m = torch.as_tensor(boxes_m, dtype=torch.float32)
    if boxes_m.dim() < 3 or tuple(boxes_m.shape[-2:]) != (2, 4):
        raise ValueError(f"boxes must be [..., N, 2, 4], got {tuple(boxes_m.shape)}")
    lead, n = boxes_m.shape[:-3], boxes_m.shape[-3]
    dev = boxes_m.device
    b = math.prod(lead)
    boxes = boxes_m.reshape(b, n, 2, 4)
    scale, offset = (torch.tensor(v, dtype=torch.float32, device=dev) for v in raster_geometry(size))
    ring = list(RING)
    px = (boxes[:, :, 0, :] * scale + offset)[:, :, ring]  # [b, n, 4]
    py = (boxes[:, :, 1, :] * scale + offset)[:, :, ring]
    nx, ny = px.roll(-1, dims=-1), py.roll(-1, dims=-1)
    ex, ey = nx - px, ny - py
    terms = px * ny - nx * py
    area2 = ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]  # left to right
    ok = area2.abs() > 1e-6
    if valid is not None:
        ok = ok & torch.as_tensor(valid, device=dev).reshape(b, n).bool()
    sign = torch.where(area2 >= 0, 1.0, -1.0)

    rows = torch.arange(size, dtype=torch.float32, device=dev).view(1, size, 1)  # pre-flip y
    cols = torch.arange(size, dtype=torch.float32, device=dev).view(1, 1, size)
    out = torch.zeros((b, size, size), dtype=torch.bool, device=dev)

    def per_item(t):
        return t.view(b, 1, 1)

    for i in range(n):
        inside = per_item(ok[:, i]).expand(b, size, size).clone()
        s = per_item(sign[:, i])
        for e in range(4):
            cross = (per_item(ex[:, i, e]) * (rows - per_item(py[:, i, e]))
                     - per_item(ey[:, i, e]) * (cols - per_item(px[:, i, e])))
            inside &= s * cross >= 0.0
        out |= inside
    return out.flip(-2).float().reshape(*lead, size, size)


def layout_images_as_map(x, size: int = MAP_SIZE):
    """Six camera views [b, 6, H, W, C] -> one square [b, size, size, C]
    layout image, the detection backbone's input:

        BL FL
        B  F
        BR FR

    B and F rotated 90 degrees outward, BR and FR flipped in both axes, each
    view resized bilinearly into its cell (rows size // 3, size // 3 and the
    rest; columns size // 2).

    jax.image.resize(method="linear") antialiases when it shrinks (the
    rotated B and F views shrink from W to about size / 3 rows), so the
    counterpart is F.interpolate with antialias=True; without it the rotated
    cells differ by up to 0.19 on [0, 1] images. The resize runs in f32 and
    rounds to x's dtype."""
    b, _, _, _, c = x.shape
    fl, f, fr, bl, bk, br = (x[:, i] for i in range(6))
    bk = torch.rot90(bk, 1, (1, 2))
    f = torch.rot90(f, 1, (2, 1))
    br = torch.flip(br, (1, 2))
    fr = torch.flip(fr, (1, 2))
    cell_h, cell_w = size // 3, size // 2

    def fit(img, th):
        y = F.interpolate(img.permute(0, 3, 1, 2).float(), size=(th, cell_w), mode="bilinear",
                          align_corners=False, antialias=True)
        return y.to(x.dtype).permute(0, 2, 3, 1)

    heights = (cell_h, cell_h, size - 2 * cell_h)
    grid = ((bl, fl), (bk, f), (br, fr))
    rows = [torch.cat([fit(left, th), fit(right, th)], dim=2)
            for (left, right), th in zip(grid, heights)]
    return torch.cat(rows, dim=1)
