"""FLOPs a training sample of ResNet-50: two per multiply-add of every
convolution and of the head, forward plus backward (twice the forward),
from the configuration's shapes. BatchNorm, ReLU, pooling and the loss are
left out (under 1% of the total)."""

from __future__ import annotations

import math


def _out(size: int, stride: int) -> int:
    return math.ceil(size / stride)


def forward_macs(cfg: dict) -> int:
    h = cfg["inputs"]["shape"][0]
    w = cfg["stem_width"]
    h = _out(h, 2)
    macs = h * h * 7 * 7 * 3 * w
    h = _out(h, 2)  # the 3x3 stride-2 max pool
    c_in = w
    for i, count in enumerate(cfg["stage_sizes"]):
        f = w * 2 ** i
        for j in range(count):
            s = 2 if i > 0 and j == 0 else 1
            h_out = _out(h, s)
            if s != 1 or c_in != 4 * f:
                macs += h_out * h_out * c_in * 4 * f
            macs += h * h * c_in * f + h_out * h_out * 9 * f * f + h_out * h_out * f * 4 * f
            h, c_in = h_out, 4 * f
    return macs + c_in * cfg["num_classes"]


def flops_per_sample(cfg: dict, traffic: dict) -> float:
    return 3 * 2 * forward_macs(cfg)
