"""Plain PyTorch reference of ResNet-50 (He et al. 2015, v1.5) as the
configuration states it: convolutions in bfloat16 on NCHW tensors,
BatchNorm in float32 with the biased variance max(0, E[x^2] - E[x]^2) and
running statistics moved by 1% a step, flax's SAME padding (asymmetric at
stride 2), a float32 head. Parameters carry flax's names and HWIO kernels,
so one set of weights from the seed serves the port and this reference.

`precision='fp8'` is the control: every convolution's input and kernel
pass through float8 e4m3 (per-tensor scale to its largest value) in the
forward, the step below the configuration's bfloat16. Imports nothing of the
port."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str, float]  # name, shape, init kind, scale


def _blocks(cfg: dict):
    """(block name, c_in, filters, stride, projects) of every bottleneck block."""
    c_in, b, out = cfg["stem_width"], 0, []
    for i, count in enumerate(cfg["stage_sizes"]):
        f = cfg["stem_width"] * 2 ** i
        for j in range(count):
            s = 2 if i > 0 and j == 0 else 1
            out.append((f"BottleneckBlock_{b}", c_in, f, s, s != 1 or c_in != 4 * f))
            c_in, b = 4 * f, b + 1
    return out


def param_specs(cfg: dict) -> List[Spec]:
    w = cfg["stem_width"]
    zero_last = cfg["batch_norm"]["last_scale_of_block"]
    specs: List[Spec] = [("Conv_0/kernel", (7, 7, 3, w), "normal", 1 / math.sqrt(49 * 3))]
    specs += [("BatchNorm_0/scale", (w,), "const", 1.0), ("BatchNorm_0/bias", (w,), "const", 0.0)]
    for name, c_in, f, _, proj in _blocks(cfg):
        convs = [(c_in, 4 * f, 1)] if proj else []
        convs += [(c_in, f, 1), (f, f, 3), (f, 4 * f, 1)]
        for i, (a, b, size) in enumerate(convs):
            last = i == len(convs) - 1
            specs.append((f"{name}/Conv_{i}/kernel", (size, size, a, b), "normal", 1 / math.sqrt(size * size * a)))
            specs.append((f"{name}/BatchNorm_{i}/scale", (b,), "const", zero_last if last else 1.0))
            specs.append((f"{name}/BatchNorm_{i}/bias", (b,), "const", 0.0))
    c = 4 * w * 2 ** (len(cfg["stage_sizes"]) - 1)
    specs += [("Dense_0/kernel", (c, cfg["num_classes"]), "normal", 1 / math.sqrt(c)),
              ("Dense_0/bias", (cfg["num_classes"],), "const", 0.0)]
    return specs


def stat_specs(cfg: dict) -> List[Spec]:
    """BatchNorm running statistics: mean 0, var 1."""
    out = []
    for name, shape, _, _ in param_specs(cfg):
        if "BatchNorm" in name and name.endswith("/scale"):
            base = name[: -len("/scale")]
            out += [(f"{base}/mean", shape, "const", 0.0), (f"{base}/var", shape, "const", 1.0)]
    return out


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale; the gradient passes
    straight through."""
    scale = 448.0 / x.detach().abs().amax().float().clamp(min=1e-12)
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x.detach())


class _Net:
    def __init__(self, cfg: dict, params, stats, precision: str):
        self.cfg, self.p, self.stats, self.precision = cfg, params, stats, precision
        self.dt = getattr(torch, cfg["compute_dtype"])
        bn = cfg["batch_norm"]
        self.momentum, self.eps = bn["momentum"], bn["epsilon"]
        self.new_stats: Dict[str, torch.Tensor] = {}

    def conv(self, x, name, stride, pads=None):
        k = self.p[f"{name}/kernel"]
        kh = k.shape[0]
        if pads is None:
            (t, b), (l, r) = _same(x.shape[2], kh, stride), _same(x.shape[3], kh, stride)
        else:
            (t, b), (l, r) = pads, pads
        x = x.to(self.dt)
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        w = k.permute(3, 2, 0, 1).to(self.dt)
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, stride=stride)

    def bn(self, x, name):
        x = x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            for key, v in (("mean", mean), ("var", var)):
                old = self.stats[f"{name}/{key}"]
                self.new_stats[f"{name}/{key}"] = self.momentum * old + (1 - self.momentum) * v
        mul = torch.rsqrt(var + self.eps) * self.p[f"{name}/scale"]
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.p[f"{name}/bias"][:, None, None]
        return y.to(self.dt)

    def block(self, x, name, stride, proj):
        first = 1 if proj else 0
        short = self.bn(self.conv(x, f"{name}/Conv_0", stride), f"{name}/BatchNorm_0") if proj else x
        y = x
        for i, s in enumerate((1, stride, 1)):
            y = self.bn(self.conv(y, f"{name}/Conv_{first + i}", s), f"{name}/BatchNorm_{first + i}")
            if i < 2:
                y = F.relu(y)
        return F.relu(y + short)

    def forward(self, images):
        x = F.relu(self.bn(self.conv(images.permute(0, 3, 1, 2), "Conv_0", 2, (3, 3)), "BatchNorm_0"))
        (t, b), (l, r) = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
        for name, _, _, stride, proj in _blocks(self.cfg):
            x = self.block(x, name, stride, proj)
        x = x.mean(dim=(2, 3)).float()
        return x @ self.p["Dense_0/kernel"] + self.p["Dense_0/bias"]


def loss_and_stats(cfg: dict, params, stats, batch, precision: str = "config"):
    """(mean softmax cross-entropy of `batch` = (images NHWC f32, int
    labels), the running statistics after this forward)."""
    net = _Net(cfg, params, stats, precision)
    images, labels = batch
    logits = net.forward(images)
    return F.cross_entropy(logits.float(), labels.long()), net.new_stats

