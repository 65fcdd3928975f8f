"""Roadmap threat score (driving_dirty_tpu/metrics/threat.py:24-29; parity
target the reference's src/utils/helper.py:74-77). The box ATS comes with the
box models."""
from __future__ import annotations

import torch


def ts_road_map(road_map1, road_map2):
    """Pixel threat score TP / (P1 + P2 - TP). Inputs broadcastable {0,1} maps;
    a 0-d f32 tensor on their device."""
    a = torch.as_tensor(road_map1).float()
    b = torch.as_tensor(road_map2, device=a.device).float()
    tp = torch.sum(a * b)
    return tp / (torch.sum(a) + torch.sum(b) - tp)
