"""Spatial BEV components of the box-occupancy models
(driving_dirty_tpu/nn/spatial.py): the camera->BEV mapping (per-view
anisotropic convs, oriented and tiled into a 3x2 grid) and the two
merge/upsample heads. NHWC throughout; parameter names as in the JAX
package. Plain convs and transposed convs, which the JAX package leaves to
XLA, run through torch (cuDNN on the card).

Under a 'model' mesh axis the task's sharding rules
(models/spatial_bb.py) cut every conv and transposed conv of these heads
with 8k output channels, and each runs column-parallel
(core/layers.py): it computes this rank's output channels from the whole
input and all-gathers them, so every layer that follows (the next conv,
the merge concatenation, the 1-channel last stage, which stays whole)
sees every channel. SpatialMappingCNN gathers once, after its six
per-view convs are tiled, in place of six gathers.

Shapes at the "reference" geometry (camera views 256x306):
  SpatialMappingCNN:      [b, 6, 256, 306, 3] -> [b, 256, 256, 32]
  BoxesMergingCNN:        ssr [b, 128, 918, 32] + spatial -> [b, 800, 800, 1]
  RoadMapBoxesMergingCNN: + roadmap [b, 800, 800, 1]      -> [b, 800, 800, 1]
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.parallel import collectives as C

# Resolution presets. "reference" is the reference architecture (256x306
# views -> 256x256 BEV grid -> 800x800 raster); "small" is the same network
# (layer names, channel counts, orientation and tiling) with its kernel
# geometry re-solved for 64x78 views -> 64x64 grid -> 148/152-px rasters.
GEOMETRIES = {
    "reference": dict(
        view_hw=(256, 306),
        grid_hw=(256, 256),
        side=dict(kernel_size=(1, 50), stride=(3, 2), padding=0),
        axial=dict(kernel_size=(52, 1), stride=(3, 2), padding=1),
        ss=dict(kernel_size=(1, 24), stride=(1, 7), padding=0),
        # ConvTranspose stages as (in, out, k, s, p, out_pad, dilation)
        boxes_up=[(64, 32, 8, 1, 0, 0, 8), (32, 16, 8, 1, 0, 0, 8),
                  (16, 8, 6, 1, 0, 2, 6), (8, 1, 2, 2, 0, 0, 1)],
        boxes_raster=800,
        rm_conv_1=dict(kernel_size=7, stride=3, padding=1, dilation=3),
        rm_up=[(96, 64, 7, 1, 0, 0, 7), (64, 32, 7, 1, 0, 0, 7),
               (32, 16, 7, 1, 0, 0, 7), (16, 8, 7, 1, 0, 0, 3),
               (8, 1, 2, 2, 0, 0, 1)],
        rm_raster=800,
    ),
    "small": dict(
        view_hw=(64, 78),
        grid_hw=(64, 64),
        side=dict(kernel_size=(1, 14), stride=(3, 2), padding=0),
        axial=dict(kernel_size=(13, 1), stride=(3, 2), padding=(0, 1)),
        ss=dict(kernel_size=(1, 17), stride=(1, 7), padding=0),
        boxes_up=[(64, 32, 3, 1, 0, 0, 2), (32, 16, 3, 1, 0, 0, 2),
                  (16, 8, 3, 1, 0, 0, 1), (8, 1, 2, 2, 0, 0, 1)],
        boxes_raster=148,
        rm_conv_1=dict(kernel_size=8, stride=2, padding=1, dilation=2),
        rm_up=[(96, 64, 3, 1, 0, 0, 2), (64, 32, 3, 1, 0, 0, 2),
               (32, 16, 3, 1, 0, 0, 1), (16, 8, 3, 1, 0, 0, 1),
               (8, 1, 2, 2, 0, 0, 1)],
        rm_raster=152,
    ),
}


class SpatialMappingCNN(nn.Module):
    """Per-view conv, orient and tile into the BEV grid

        BL FL
        B  F
        BR FR

    View order on input is the dataset order FL, F, FR, BL, B, BR."""

    def __init__(self, geometry: str = "reference", *, device=None, generator=None):
        super().__init__()
        g = GEOMETRIES[geometry]
        kw = dict(device=device, generator=generator)
        # registration order = the JAX package's init order
        self.fl_conv = L.Conv2d(3, 32, **g["side"], **kw)
        self.fr_conv = L.Conv2d(3, 32, **g["side"], **kw)
        self.bl_conv = L.Conv2d(3, 32, **g["side"], **kw)
        self.br_conv = L.Conv2d(3, 32, **g["side"], **kw)
        self.f_conv = L.Conv2d(3, 32, **g["axial"], **kw)
        self.b_conv = L.Conv2d(3, 32, **g["axial"], **kw)
        self.out_conv = L.Conv2d(32, 32, 3, 1, 0, **kw)

    def forward(self, x):
        # under tp the per-view convs give this rank's channels, gathered
        # once for the tiled grid
        kw = dict(gather=False)
        fl = torch.relu(self.fl_conv(x[:, 0], **kw))
        bl = torch.relu(self.bl_conv(x[:, 3], **kw))
        # the reference's rot90 on NCHW planes (2,3) / (3,2) == NHWC axes (1,2) / (2,1)
        b_ = torch.relu(self.b_conv(torch.rot90(x[:, 4], 1, dims=(1, 2)), **kw))
        f_ = torch.relu(self.f_conv(torch.rot90(x[:, 1], 1, dims=(2, 1)), **kw))
        br = torch.relu(self.br_conv(torch.flip(x[:, 5], dims=(1, 2)), **kw))
        fr = torch.relu(self.fr_conv(torch.flip(x[:, 2], dims=(1, 2)), **kw))
        grid = torch.cat([torch.cat([bl, fl], dim=2),
                          torch.cat([b_, f_], dim=2),
                          torch.cat([br, fr], dim=2)], dim=1)
        tp = self.fl_conv.tp
        if tp is not None:
            grid = C.gather_from_tp(grid, tp[1])
        return torch.relu(self.out_conv(grid))


def _up_stages(module, stages, kw):
    for i, (cin, cout, k, s, p, op, d) in enumerate(stages, start=1):
        setattr(module, f"up_conv_{i}", L.ConvTranspose2d(cin, cout, k, s, p, op, d, **kw))
    return len(stages)


def _upsample(module, x, n_up):
    """ReLU after every upsampling stage but the last, which ends in a sigmoid.

    The stages run on NCHW-contiguous tensors (x becomes an NHWC view of
    one, and each stage's output stays one): cuDNN's channels-last backward
    of spatial_rm's first stage (96->64, k7, dilation 7, batch 8 at 256x256)
    took 643 ms a training step on an H100, against tens of ms in NCHW
    (chip_smoke.py, box-training phase)."""
    x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    for i in range(1, n_up):
        x = torch.relu(getattr(module, f"up_conv_{i}")(x))
    return torch.sigmoid(getattr(module, f"up_conv_{n_up}")(x))


class BoxesMergingCNN(nn.Module):
    """Resample the SSL c3 features to the BEV grid, concatenate with the
    spatial map, upsample to a [b, raster, raster, 1] sigmoid."""

    def __init__(self, geometry: str = "reference", *, device=None, generator=None):
        super().__init__()
        g = GEOMETRIES[geometry]
        kw = dict(device=device, generator=generator)
        self.raster_size = g["boxes_raster"]
        self.ss_conv = L.Conv2d(32, 32, **g["ss"], **kw)
        self.ss_deconv = L.ConvTranspose2d(32, 32, 2, 2, 0, **kw)
        self.n_up = _up_stages(self, g["boxes_up"], kw)

    def forward(self, ssr, spatial_map):
        x = torch.relu(self.ss_conv(ssr))
        x = torch.relu(self.ss_deconv(x))
        return _upsample(self, torch.cat([x, spatial_map], dim=-1), self.n_up)


class RoadMapBoxesMergingCNN(nn.Module):
    """BoxesMergingCNN plus a road-map branch: 96-channel merge, five
    upsampling stages."""

    def __init__(self, geometry: str = "reference", *, device=None, generator=None):
        super().__init__()
        g = GEOMETRIES[geometry]
        kw = dict(device=device, generator=generator)
        self.raster_size = g["rm_raster"]
        self.ss_conv = L.Conv2d(32, 32, **g["ss"], **kw)
        self.ss_deconv = L.ConvTranspose2d(32, 32, 2, 2, 0, **kw)
        self.rm_conv_1 = L.Conv2d(1, 32, **g["rm_conv_1"], **kw)
        self.rm_conv_2 = L.Conv2d(32, 32, 3, 1, 0, 3, **kw)
        self.n_up = _up_stages(self, g["rm_up"], kw)

    def forward(self, ssr, spatial_map, rm):
        x = torch.relu(self.ss_conv(ssr))
        x = torch.relu(self.ss_deconv(x))
        r = torch.relu(self.rm_conv_1(rm))
        r = torch.relu(self.rm_conv_2(r))
        return _upsample(self, torch.cat([x, spatial_map, r], dim=-1), self.n_up)
