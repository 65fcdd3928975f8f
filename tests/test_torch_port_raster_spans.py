"""The rule kernel B2 (driving_dirty_tpu_torch/csrc/raster.cu) rests on,
proven on the CPU: for a fixed row every edge test is monotone in the
column, so a box covers one interval of columns per row, and that interval,
found with the plain version's rounded predicate, rebuilds the plain map.

`span_raster` below emulates the kernel in float32 PyTorch: the same
per-box records (ring, scale, doubled area, sign folded into the edges,
the 2^60 px bound beyond which a box is tested pixel by pixel), the same
cull of boxes per tile of 16 output rows (bounds on each edge's column
range at the tile's first and last row, from one exact edge test beside
the estimated crossing; the edge's threshold is monotone in the row as
well, so those two bound it over the tile), each edge's half-line
searched inside the interval the earlier edges left, by bisection on the
exact predicate, and clipped to the map. It must equal the plain version
(ops/maps.py:boxes_to_binary_map) bit for bit: one differing pixel is a
fault. `kernel_search` is the kernel's own search
(estimate, gallop, bisect) written out in numpy float32 scalars; it must
find what bisection finds from any estimate. The kernel itself is held to
the plain version on the card (tests/test_torch_port_gpu.py,
chip_smoke.py), on the same box sets.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import numpy as np
import pytest
import torch

from driving_dirty_tpu_torch.data.boxes import adversarial_boxes, box_scenes
from driving_dirty_tpu_torch.ops.maps import RING, raster_geometry
from driving_dirty_tpu_torch.ops.maps import boxes_to_binary_map as raster_plain

SIZES = [800, 148, 157]
REGULAR = 2.0 ** 60
ROWS = 16  # output rows of a span-kernel tile
SETS = {"box_scenes": box_scenes, "adversarial": adversarial_boxes}


def records(boxes, valid, size):
    """The kernel's per-box prologue: ring corners, sign-folded edges, and
    which boxes are regular (spans) or irregular (pixel tests)."""
    scale, offset = (torch.tensor(v, dtype=torch.float32) for v in raster_geometry(size))
    ring = list(RING)
    px = (boxes[:, :, 0, :] * scale + offset)[:, :, ring]
    py = (boxes[:, :, 1, :] * scale + offset)[:, :, ring]
    nx, ny = px.roll(-1, dims=-1), py.roll(-1, dims=-1)
    terms = px * ny - nx * py
    area2 = ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]
    sign = torch.where(area2 >= 0, 1.0, -1.0)[..., None]
    ok = valid & (area2.abs() > 1e-6)
    regular = (px.abs() <= REGULAR).all(-1) & (py.abs() <= REGULAR).all(-1)
    return px, py, sign * (nx - px), sign * (ny - py), ok & regular, ok & ~regular


def edge_ok(t1, sey, ax, x):
    return (t1 - sey * (x.to(torch.float32) - ax)) >= 0


def last_of_prefix(t1, sey, ax, lo, hi, neg):
    """Per element: the last x in [lo, hi] with q on all of [lo, x] (lo - 1
    if none), q = edge_ok != neg, a prefix predicate; by bisection."""
    a, b = lo - 1, hi + 1
    while bool(((b - a) > 1).any()):
        active = (b - a) > 1
        m = torch.where(active, (a + b) // 2, a.clamp(min=0))
        q = edge_ok(t1, sey, ax, m) != neg
        a = torch.where(active & q, m, a)
        b = torch.where(active & ~q, m, b)
    return a


def spans(px, py, sex, sey, size):
    """[B, N, size] intervals [lo, hi] of each box in each pre-flip row."""
    bn = px.shape[:2]
    yy = torch.arange(size, dtype=torch.float32).view(1, 1, size)
    lo = torch.zeros((*bn, size), dtype=torch.int64)
    hi = torch.full((*bn, size), size - 1, dtype=torch.int64)
    for e in range(4):
        ax, ay = px[..., e, None], py[..., e, None]
        ex, ey = sex[..., e, None].expand(-1, -1, size), sey[..., e, None].expand(-1, -1, size)
        t1 = ex * (yy - ay)
        up = last_of_prefix(t1, ey, ax, lo, hi, False)
        down = last_of_prefix(t1, ey, ax, lo, hi, True) + 1
        hi = torch.where(ey > 0, torch.minimum(hi, up), hi)
        lo = torch.where(ey < 0, torch.maximum(lo, down), lo)
        hi = torch.where((ey == 0) & ~(t1 >= 0), lo - 1, hi)
    return lo, hi


def edge_ranges(px, py, sex, sey, size):
    """[4, B, N, size] column ranges (lo, hi) each edge alone admits in each
    pre-flip row, on the whole map; empty as lo > hi."""
    yy = torch.arange(size, dtype=torch.float32).view(1, 1, size)
    los, his = [], []
    for e in range(4):
        ax, ay = px[..., e, None], py[..., e, None]
        ey = sey[..., e, None].expand(-1, -1, size)
        t1 = sex[..., e, None] * (yy - ay)
        lo = torch.zeros(t1.shape, dtype=torch.int64)
        hi = torch.full(t1.shape, size - 1, dtype=torch.int64)
        up = last_of_prefix(t1, ey, ax, lo, hi, False)
        down = last_of_prefix(t1, ey, ax, lo, hi, True) + 1
        level_fails = (ey == 0) & ~(t1 >= 0)
        los.append(torch.where(ey < 0, down, torch.where(level_fails, size, lo)))
        his.append(torch.where(ey > 0, up, torch.where(level_fails, -1, hi)))
    return torch.stack(los), torch.stack(his)


def edge_bounds(px, py, sex, sey, size):
    """The kernel's cull bounds (csrc/raster.cu:edge_range, exact false):
    [4, B, N, size] (lo, hi) per edge and pre-flip row, from one exact edge
    test two columns past the estimated crossing; they contain what
    edge_ranges gives."""
    yy = torch.arange(size, dtype=torch.float32).view(1, 1, size)
    los, his = [], []
    for e in range(4):
        ax, ay = px[..., e, None], py[..., e, None]
        ey = sey[..., e, None].expand(-1, -1, size)
        t1 = sex[..., e, None] * (yy - ay)
        est = torch.where(ey > 0, ax + t1 / ey + 2, ax + t1 / ey - 2)
        x = torch.nan_to_num(est, nan=0.0).clamp(0, size - 1).to(torch.int64)
        fails = ~edge_ok(t1, ey, ax, x)
        level_fails = (ey == 0) & ~(t1 >= 0)
        lo = torch.where((ey < 0) & fails, x + 1, 0)
        hi = torch.where((ey > 0) & fails, x - 1, size - 1)
        los.append(torch.where(level_fails, size, lo))
        his.append(torch.where(level_fails, -1, hi))
    return torch.stack(los), torch.stack(his)


def tile_keep(lo, hi, size):
    """[B, N, tiles]: whether a box may cover a row of each tile of ROWS
    output rows, from each edge's range at the tile's first and last row."""
    keep = []
    for r0 in range(0, size, ROWS):
        first, last = size - 1 - r0, size - 1 - min(r0 + ROWS, size) + 1
        lo_t = torch.minimum(lo[..., first], lo[..., last]).amax(0)
        hi_t = torch.maximum(hi[..., first], hi[..., last]).amin(0)
        keep.append(lo_t <= hi_t)
    return torch.stack(keep, -1)


def span_raster(boxes, valid, size):
    """The kernel's map, emulated: [B, N, 2, 4] + [B, N] -> [B, size, size]."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool)
    px, py, sex, sey, reg, irr = records(boxes, valid, size)
    lo, hi = spans(px, py, sex, sey, size)
    tiles = tile_keep(*edge_bounds(px, py, sex, sey, size), size)
    tile_of_row = (size - 1 - torch.arange(size)) // ROWS  # pre-flip row -> tile
    keep = reg[..., None] & (lo <= hi) & tiles[..., tile_of_row]
    b = boxes.shape[0]
    marks = torch.zeros((b, size, size + 1))
    marks.scatter_add_(2, lo.where(keep, 0).transpose(1, 2), keep.float().transpose(1, 2))
    marks.scatter_add_(2, (hi + 1).where(keep, 0).transpose(1, 2), -keep.float().transpose(1, 2))
    out = marks.cumsum(-1)[..., :size] > 0
    yy = torch.arange(size, dtype=torch.float32).view(size, 1)
    xx = torch.arange(size).view(1, size)
    for i, n in zip(*torch.nonzero(irr, as_tuple=True)):
        inside = torch.ones((size, size), dtype=torch.bool)
        for e in range(4):
            inside &= edge_ok(sex[i, n, e] * (yy - py[i, n, e]), sey[i, n, e], px[i, n, e], xx)
        out[i] |= inside
    return out.flip(-2).float()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("boxes", sorted(SETS))
def test_span_emulation_equals_plain_bit_for_bit(boxes, size):
    b, v = SETS[boxes](3, batch=8, max_bb=100)
    ref = raster_plain(torch.from_numpy(b), torch.from_numpy(v), size)
    got = span_raster(b, v, size)
    assert int((got != ref).sum()) == 0
    assert 0 < ref.sum() < ref.numel()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("boxes", sorted(SETS))
def test_edge_thresholds_are_monotone_in_the_row_and_the_cull_is_exact(boxes, size):
    """What the kernel's tile cull rests on: each edge's column range moves
    one way as the row grows. And the cull drops only (tile, box) pairs
    whose exact spans are empty in every row of the tile."""
    b, v = SETS[boxes](4, batch=8, max_bb=100)
    px, py, sex, sey, reg, _ = records(torch.from_numpy(b), torch.from_numpy(v), size)
    lo, hi = edge_ranges(px, py, sex, sey, size)
    for bound in (lo, hi):
        step = bound.diff(dim=-1)[:, reg]
        assert bool(((step >= 0).all(-1) | (step <= 0).all(-1)).all())
    b_lo, b_hi = edge_bounds(px, py, sex, sey, size)
    assert bool(((b_lo <= lo) | (lo > hi))[:, reg].all() and ((b_hi >= hi) | (lo > hi))[:, reg].all())
    s_lo, s_hi = spans(px, py, sex, sey, size)
    covered = reg[..., None] & (s_lo <= s_hi)  # [B, N, pre-flip rows]
    tile_of_row = (size - 1 - torch.arange(size)) // ROWS
    for tiles in (tile_keep(lo, hi, size), tile_keep(b_lo, b_hi, size)):
        assert not bool((covered & ~tiles[..., tile_of_row]).any())
        assert float(tiles[reg].float().mean()) < 0.5  # and it does cull


def test_adversarial_set_reaches_every_branch():
    """Irregular boxes are tested pixel by pixel, and every other kind of
    edge (rising, falling, level) is searched."""
    b, v = adversarial_boxes(3, batch=8, max_bb=100)
    _, _, _, sey, reg, irr = records(torch.from_numpy(b), torch.from_numpy(v), 800)
    assert int(irr.sum()) >= 4 and int(reg.sum()) > 300
    edges = sey[reg]
    assert bool((edges > 0).any() and (edges < 0).any() and (edges == 0).any())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("boxes", sorted(SETS))
def test_every_box_covers_one_interval_per_row(boxes, size):
    """On the plain version, each valid box alone: in every row, the pixels
    it sets are consecutive."""
    b, v = SETS[boxes](5, batch=2, max_bb=100)
    b, v = b.reshape(-1, 1, 2, 4), v.reshape(-1, 1)
    maps = raster_plain(torch.from_numpy(b), torch.from_numpy(v), size)
    runs = (maps[..., 1:] > maps[..., :-1]).sum(-1) + maps[..., 0]
    assert int(runs.max()) == 1
    assert int((runs > 0).sum()) > 100


def kernel_search(t1, sey, ax, est, lo, hi, neg):
    """csrc/raster.cu:last_of_prefix, step for step, in float32 scalars."""
    def q(x):
        return bool(np.float32(t1 - np.float32(sey * np.float32(np.float32(x) - ax))) >= 0) != neg

    est = np.float32(est)
    c = lo if np.isnan(est) else int(min(max(est, np.float32(lo)), np.float32(hi)))
    if q(c):
        a, step = c, 1
        while True:
            if a >= hi:
                return hi
            n = min(a + step, hi)
            if q(n):
                a, step = n, 2 * step
            else:
                b = n
                break
    else:
        b, step = c, 1
        while True:
            if b <= lo:
                return lo - 1
            n = max(b - step, lo)
            if q(n):
                a = n
                break
            b, step = n, 2 * step
    while b - a > 1:
        m = (a + b) >> 1
        if q(m):
            a = m
        else:
            b = m
    return a


def test_kernel_search_finds_what_bisection_finds():
    """From the crossing estimate, from estimates off by up to the whole
    row, from NaN and from infinities, on every regular edge of the
    adversarial boxes at sampled rows and column ranges."""
    rng = np.random.RandomState(0)
    size = 800
    b, v = adversarial_boxes(1, batch=4, max_bb=100)
    px, py, sex, sey, reg, _ = (t.numpy() for t in records(torch.from_numpy(b),
                                                              torch.from_numpy(v), size))
    cases = 0
    for i, n in zip(*np.nonzero(reg)):
        for e in range(4):
            if sey[i, n, e] == 0:
                continue
            for _ in range(3):
                yy = np.float32(rng.randint(size))
                lo = int(rng.randint(size))
                hi = int(rng.randint(lo, size))
                t1 = np.float32(sex[i, n, e] * np.float32(yy - py[i, n, e]))
                neg = bool(sey[i, n, e] < 0)
                ref = last_of_prefix(*(torch.tensor([x]) for x in (t1, sey[i, n, e], px[i, n, e])),
                                     torch.tensor([lo]), torch.tensor([hi]), neg).item()
                with np.errstate(all="ignore"):
                    crossing = np.float32(px[i, n, e] + t1 / sey[i, n, e])
                for est in (crossing, crossing + rng.uniform(-size, size), np.nan, np.inf, -np.inf):
                    assert kernel_search(t1, sey[i, n, e], px[i, n, e], est, lo, hi, neg) == ref
                    cases += 1
    assert cases > 2000
