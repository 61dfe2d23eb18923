"""Host-path PolyFit with searched knots and transmitted breaks, ported from
`deepreduce_tpu/codecs/polyfit_host.py` (the reference's `PolyFitCPU`,
pytorch/deepreduce.py:560-688).

Unlike the on-device PolyFit (geometric segments re-derived from (N,
num_pos)), this variant searches its knots by the recursive largest
distance from the chord (`find_breaks`), fits each segment with
`np.polynomial.polynomial.polyfit` and transmits the breaks beside the
coefficients. Positive values are knot-searched in reversed (ascending)
order, the negatives in sorted order, and the sign boundary is always a
break. The sort and the mapping stay on the device; only the knot search
and the per-segment fit (and the decode's evaluation) run on the host
(`codecs.host`), with the same numpy calls as the JAX codec, so the
coefficients are bitwise its own (`np.polyfit` warns of a poorly
conditioned fit on long segments in both packages).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.codecs import host
from deepreduce_tpu_torch.sparse import SparseGrad

NUM_BREAKS = 5  # reference default (pytorch/deepreduce.py:632)
MIN_TAIL = 20  # `20 * num_of_breaks` guard (:574,578) scaled per break


def find_breaks(curve: np.ndarray, num_breaks: int = NUM_BREAKS) -> list:
    """Recursive ascending knot search: repeatedly split at the point of
    max |curve - chord| over the remaining suffix (reference :566-582)."""
    y = curve
    breaks = []
    base = 0
    for _ in range(num_breaks):
        if len(y) < MIN_TAIL * num_breaks:
            break
        line = np.linspace(y[0], y[-1], len(y))
        off = int(np.argmax(np.abs(line - y)))
        base += off
        if len(curve) - base < MIN_TAIL * num_breaks:
            break
        breaks.append(base)
        y = curve[base:]
    return breaks


def _fit_host(vals_sorted: np.ndarray, degree: int) -> Tuple[np.ndarray, np.ndarray, np.int32]:
    """Returns (coeffs [S, degree+1] f32, breaks [S+1] i32, n_seg)."""
    y = vals_sorted.astype(np.float64)
    num_pos = int(np.sum(y > 0))
    n = len(y)
    if num_pos == 0:
        breaks = find_breaks(y)
    elif num_pos == n:
        rev = find_breaks(y[::-1])
        breaks = sorted(n - b for b in rev)
    else:
        rev = find_breaks(y[:num_pos][::-1])
        breaks_pos = sorted(num_pos - b for b in rev)
        breaks_neg = [num_pos + b for b in find_breaks(y[num_pos:])]
        breaks = breaks_pos + [num_pos] + breaks_neg
    bounds = [0] + sorted(set(b for b in breaks if 0 < b < n)) + [n]

    max_seg = 2 * NUM_BREAKS + 2
    coeffs = np.zeros((max_seg, degree + 1), np.float32)
    out_bounds = np.zeros(max_seg + 1, np.int32)
    n_seg = len(bounds) - 1
    for s in range(n_seg):
        lo, hi = bounds[s], bounds[s + 1]
        x = np.arange(lo, hi, dtype=np.float64)
        c = np.polynomial.polynomial.polyfit(x, y[lo:hi], min(degree, max(1, hi - lo - 1)))
        coeffs[s, : len(c)] = c.astype(np.float32)
        out_bounds[s + 1] = hi
    out_bounds[n_seg + 1 :] = n
    return coeffs, out_bounds, np.int32(n_seg)


def _eval_host(coeffs: np.ndarray, bounds: np.ndarray, n_seg: int, n: int) -> np.ndarray:
    y = np.zeros(n, np.float32)
    for s in range(int(n_seg)):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        x = np.arange(lo, hi, dtype=np.float64)
        y[lo:hi] = np.polynomial.polynomial.polyval(x, coeffs[s].astype(np.float64)).astype(
            np.float32
        )
    return y


@dataclasses.dataclass(frozen=True)
class PolyFitHostMeta:
    k: int
    degree: int = 5

    @property
    def max_segments(self) -> int:
        return 2 * NUM_BREAKS + 2


@dataclasses.dataclass(frozen=True)
class PolyFitHostPayload:
    coeffs: torch.Tensor  # f32[S, degree + 1]
    bounds: torch.Tensor  # i32[S + 1]: the transmitted breaks
    n_seg: torch.Tensor  # i32[]
    indices: torch.Tensor  # i32[k] in value-sorted order (the mapping)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.coeffs, self.bounds, self.n_seg, self.indices)


def encode(sp: SparseGrad, meta: PolyFitHostMeta) -> PolyFitHostPayload:
    dev = sp.values.device
    order = torch.argsort(-sp.values, stable=True)
    vals = sp.values[order]
    with host.span("polyfit_host.encode"):
        coeffs, bounds, n_seg = _fit_host(host.to_host(vals), meta.degree)
    return PolyFitHostPayload(coeffs=host.to_device(coeffs, dev), bounds=host.to_device(bounds, dev),
                              n_seg=host.scalar(n_seg, dev), indices=sp.indices[order])


def decode(payload: PolyFitHostPayload, meta: PolyFitHostMeta, shape: Tuple[int, ...],
           host_payload: Optional[PolyFitHostPayload] = None) -> SparseGrad:
    """`host_payload`: the same payload's leaves on the host, if the caller
    has copied them already."""
    dev = payload.coeffs.device
    with host.span("polyfit_host.decode"):
        src = payload if host_payload is None else host_payload
        coeffs, bounds, n_seg = (host.to_host(t) for t in (src.coeffs, src.bounds, src.n_seg))
        vals = _eval_host(coeffs, bounds, int(n_seg), meta.k)
    return SparseGrad(values=host.to_device(vals, dev), indices=payload.indices,
                      nnz=host.scalar(meta.k, dev), shape=shape)


def wire_bits(payload: PolyFitHostPayload, meta: PolyFitHostMeta) -> torch.Tensor:
    return payload.n_seg.to(torch.float32) * ((meta.degree + 1) * 32 + 32) + 32
