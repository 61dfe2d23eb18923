"""PolySeg value codec: a whole-layer sort and a searched segment fit,
ported from `deepreduce_tpu/codecs/polyseg.py`.

The magnitudes are sorted descending (the signs ride on the indices as
`(idx + 1) * sign`), the sorted curve is split at `num_segments - 1` knots,
each the point farthest from the chord of the remaining suffix (a masked
argmax of |chord - curve|), and every segment is fitted by PolyFit's
least squares in the shifted-Legendre basis (`codecs.polyfit`: its element
basis and jitter, one batched `torch.linalg.solve_ex`). The breaks
(i32[S + 1]) and the coefficients cross the wire.

A near-tie in the argmax decides a break, and a break moves whole
segments, so the chord is the float32 arithmetic of the JAX package's
jitted program: `y_b + (y_last - y_b) * (i - b) / span` with an IEEE
divide by the traced span. The order, the breaks and the signed indices
are bitwise equal to the JAX package's; the coefficients, summed and
solved in another order, agree to a tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from deepreduce_tpu_torch.codecs import polyfit as _pf
from deepreduce_tpu_torch.sparse import SparseGrad


def default_num_segments(n: int) -> int:
    """2..5 segments growing with the layer's size (~log10 n)."""
    return max(2, min(5, int(math.log10(max(n, 10)))))


@dataclasses.dataclass(frozen=True)
class PolySegMeta:
    k: int
    degree: int = 5

    @property
    def segments(self) -> int:
        return default_num_segments(self.k)


@dataclasses.dataclass(frozen=True)
class PolySegPayload:
    coeffs: torch.Tensor  # f32[S, degree + 1]
    breaks: torch.Tensor  # i32[S + 1], ascending, 0 and k included
    signed_indices: torch.Tensor  # i32[k]: (idx + 1) * sign, descending |value| (i32[0] once stripped)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.coeffs, self.breaks, self.signed_indices)


def find_breaks(y: torch.Tensor, num_segments: int) -> torch.Tensor:
    """i32[S + 1] ascending breaks, 0 and k included: each of the S - 1
    rounds splits the suffix from the last break b at the point farthest
    from its chord (the first such point on a tie)."""
    k = y.shape[0]
    dev = y.device
    i = torch.arange(k, dtype=torch.float32, device=dev)
    y_last = y[-1]
    b = torch.zeros(1, dtype=torch.int64, device=dev)
    breaks = [b]
    for _ in range(num_segments - 1):
        y_b = y.index_select(0, b)
        bf = b.to(torch.float32)
        span = torch.clamp(float(k - 1) - bf, min=1.0)
        line = y_b + (y_last - y_b) * (i - bf) / span
        dist = torch.where(i >= bf, (line - y).abs(), -1.0)
        b = torch.argmax(dist).reshape(1)
        breaks.append(b)
    breaks.append(torch.full((1,), k, dtype=torch.int64, device=dev))
    return torch.sort(torch.cat(breaks)).values.to(torch.int32)


def encode(sp: SparseGrad, meta: PolySegMeta) -> PolySegPayload:
    mags = sp.values.abs()
    order = torch.sort(-mags, stable=True).indices  # descending |value|
    y = mags[order]
    idx1 = sp.indices[order].to(torch.int32) + 1
    signed = idx1 * torch.sign(sp.values[order]).to(torch.int32)
    signed = torch.where(signed == 0, idx1, signed)

    s, p = meta.segments, meta.degree + 1
    breaks = find_breaks(y, s)
    sizes = breaks[1:] - breaks[:-1]
    seg_id, phi = _pf._element_basis(meta.k, sizes, meta.degree)
    dev = y.device
    a = torch.zeros(s, p, p, dtype=torch.float32, device=dev).index_add_(0, seg_id, phi[:, :, None] * phi[:, None, :])
    b = torch.zeros(s, p, dtype=torch.float32, device=dev).index_add_(0, seg_id, phi * y[:, None])
    eye = torch.eye(p, dtype=torch.float32, device=dev)
    coeffs = torch.linalg.solve_ex(a + _pf.jitter(a, p) * eye, b[..., None]).result[..., 0]
    return PolySegPayload(coeffs=coeffs, breaks=breaks, signed_indices=signed)


def decode(payload: PolySegPayload, meta: PolySegMeta, shape: Tuple[int, ...]) -> SparseGrad:
    sizes = payload.breaks[1:] - payload.breaks[:-1]
    seg_id, phi = _pf._element_basis(meta.k, sizes, meta.degree)
    y = (phi * payload.coeffs[seg_id]).sum(dim=-1)
    sign = torch.sign(payload.signed_indices).to(torch.float32)
    idxs = payload.signed_indices.abs() - 1
    return SparseGrad(
        values=y * sign,
        indices=torch.clamp(idxs, min=0).to(torch.int32),
        nnz=torch.full((), meta.k, dtype=torch.int32, device=y.device),
        shape=shape,
    )


def wire_bits(payload: PolySegPayload, meta: PolySegMeta) -> torch.Tensor:
    s = meta.segments
    return torch.full((), float(s * (meta.degree + 1) * 32 + (s + 1) * 32), dtype=torch.float32,
                      device=payload.coeffs.device)
