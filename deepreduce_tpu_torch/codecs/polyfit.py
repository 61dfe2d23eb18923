"""Segmented polynomial curve-fit value codec (PolyFit), ported from
`deepreduce_tpu/codecs/polyfit.py`.

The values are sorted descending (the order is the payload's `indices`,
the 'both' mode's mapping), the sorted curve is cut into geometric
segments whose sizes follow from (k, num_pos) alone, and each segment is
fitted by a degree-5 least-squares polynomial in a shifted-Legendre basis
on its normalized domain. Only the coefficients, `num_pos` and the order
cross the wire; the receiver re-derives the segments from (k, num_pos) and
evaluates.

The segment structure is bitwise the JAX package's: the sizes floor
float32(num_pos) * float32(ratio), the element basis is the float32
arithmetic of the JAX package's jitted program (the Legendre recurrence and
the jitter as the fused multiply-adds XLA:CPU contracts them to,
`numerics.fma_f32`), and the sort is stable. The normal equations are summed with
`index_add_` into [S, p, p] / [S, p] and solved by one batched
`torch.linalg.solve_ex` on the tensor's own device (no host round trip, no
host sync); the sums and the LU round differently from XLA's, so the
coefficients agree with the JAX package's to a tolerance, not bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.numerics import fma_f32, reciprocal_f32
from deepreduce_tpu_torch.sparse import SparseGrad

RATIOS = (1 / 5, 1 / 10, 1 / 30, 1 / 100, 1 / 300, 1 / 1000, 1 / 3000, 1 / 10000, 1 / 30000, 1 / 100000)
MIN_SEGMENT = 30  # segments of at most this many values are merged into the remainder


@dataclasses.dataclass(frozen=True)
class PolyFitMeta:
    k: int
    degree: int = 5
    sort: bool = False  # True: the values arrive already sorted descending

    @property
    def num_segments(self) -> int:
        return 2 * len(RATIOS) + 2


@dataclasses.dataclass(frozen=True)
class PolyFitPayload:
    coeffs: torch.Tensor  # f32[S, degree+1], Legendre basis per segment
    num_pos: torch.Tensor  # i32[] — the receiver's key to the segment structure
    indices: torch.Tensor  # i32[k] in value-sorted order (i32[0] once stripped in 'both' mode)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.coeffs, self.num_pos, self.indices)


_RATIOS_ON: Dict[torch.device, torch.Tensor] = {}


def ratios_on(device) -> torch.Tensor:
    """RATIOS as float32 on `device`, copied there once. A copy from the
    host waits for the device, so `TensorCodec` calls this when it is built,
    and no training step pays for it."""
    dev = torch.empty(0, device=device).device  # the device with its index
    if dev not in _RATIOS_ON:
        _RATIOS_ON[dev] = torch.tensor(RATIOS, dtype=torch.float32).to(dev)
    return _RATIOS_ON[dev]


def segment_sizes(k: int, num_pos: torch.Tensor) -> torch.Tensor:
    """i32[S] segment lengths along the descending-sorted curve: fine to
    coarse positive segments, the positive remainder, the negative
    remainder, coarse to fine negative segments. Inactive ratio slots have
    length 0."""
    num_pos = num_pos.to(torch.int32)
    num_neg = k - num_pos
    r = ratios_on(num_pos.device)
    pos = torch.floor(num_pos.to(torch.float32) * r).to(torch.int32)
    neg = torch.floor(num_neg.to(torch.float32) * r).to(torch.int32)
    pos = torch.where(pos > MIN_SEGMENT, pos, 0)
    neg = torch.where(neg > MIN_SEGMENT, neg, 0)
    rem_pos = (num_pos - pos.sum()).to(torch.int32)
    rem_neg = (num_neg - neg.sum()).to(torch.int32)
    return torch.cat([pos.flip(0), rem_pos[None], rem_neg[None], neg])


def _boundaries(sizes: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(1, dtype=torch.int32, device=sizes.device)
    return torch.cat([zero, torch.cumsum(sizes, 0, dtype=torch.int32)])


def _legendre_basis(t: torch.Tensor, degree: int) -> torch.Tensor:
    """Shifted-Legendre rows P_0..P_degree at t in [-1, 1]; shape [..., degree+1].
    The recurrence `((2m+1) t P_m - m P_{m-1}) / (m+1)` as jitted XLA:CPU
    computes it: `fma(fl((2m+1) t), P_m, fl(-m P_{m-1})) * fl(1/(m+1))`."""
    cols = [torch.ones_like(t), t]
    for m in range(1, degree):
        cols.append(fma_f32((2 * m + 1) * t, cols[m], (-m) * cols[m - 1]) * reciprocal_f32(m + 1))
    return torch.stack(cols[: degree + 1], dim=-1)


def jitter(a: torch.Tensor, p: int) -> torch.Tensor:
    """[S, 1, 1] Tikhonov jitter `1e-6 * trace / p + 1e-12` of the normal
    matrices a [S, p, p], as jitted XLA:CPU computes it: the trace summed
    left to right, then `fma(trace, fl(fl(1e-6) * fl(1/p)), 1e-12)`."""
    diag = a.diagonal(dim1=-2, dim2=-1)
    tr = diag[:, 0]
    for i in range(1, p):
        tr = tr + diag[:, i]
    tr = tr[:, None, None]
    return fma_f32(tr, float(np.float32(1e-6) * np.float32(reciprocal_f32(p))), 1e-12)


def _element_basis(k: int, sizes: torch.Tensor, degree: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sorted position i: its segment id (int64) and Legendre basis row.
    x_local = 1..n within the segment, normalized to (-1, 1]."""
    bounds = _boundaries(sizes)
    i = torch.arange(k, dtype=torch.int32, device=sizes.device)
    seg_id = torch.searchsorted(bounds[1:], i, right=True)
    seg_id = torch.clamp(seg_id, 0, sizes.shape[0] - 1)
    start = bounds[seg_id]
    n = torch.clamp(sizes[seg_id], min=1)
    x_local = (i - start + 1).to(torch.float32)
    t = 2.0 * x_local / n.to(torch.float32) - 1.0
    return seg_id, _legendre_basis(t, degree)


def encode(sp: SparseGrad, meta: PolyFitMeta) -> PolyFitPayload:
    """Sort descending (stably, recording the order), then fit every
    segment in one batched solve."""
    vals, idxs = sp.values, sp.indices
    if not meta.sort:
        order = torch.argsort(-vals, stable=True)
        vals = vals[order]
        idxs = idxs[order]
    num_pos = (vals > 0.0).sum(dtype=torch.int32)

    sizes = segment_sizes(meta.k, num_pos)
    seg_id, phi = _element_basis(meta.k, sizes, meta.degree)

    s, p = meta.num_segments, meta.degree + 1
    outer = phi[:, :, None] * phi[:, None, :]  # [k, p, p]
    a = torch.zeros(s, p, p, dtype=torch.float32, device=vals.device).index_add_(0, seg_id, outer)
    b = torch.zeros(s, p, dtype=torch.float32, device=vals.device).index_add_(0, seg_id, phi * vals[:, None])
    # Tikhonov jitter keeps zero-length segments solvable (coeffs ~ 0, never
    # evaluated) without perturbing active ones; it also makes every system
    # nonsingular, so solve_ex's unchecked result is the solution
    eye = torch.eye(p, dtype=torch.float32, device=vals.device)
    coeffs = torch.linalg.solve_ex(a + jitter(a, p) * eye, b[..., None]).result[..., 0]
    return PolyFitPayload(coeffs=coeffs, num_pos=num_pos, indices=idxs.to(torch.int32))


def decode(payload: PolyFitPayload, meta: PolyFitMeta, shape: Tuple[int, ...]) -> SparseGrad:
    """Re-derive the segments from (k, num_pos) and evaluate each segment's
    polynomial: the values in sorted order, paired with `indices`."""
    sizes = segment_sizes(meta.k, payload.num_pos)
    seg_id, phi = _element_basis(meta.k, sizes, meta.degree)
    vals = (phi * payload.coeffs[seg_id]).sum(dim=-1)
    return SparseGrad(
        values=vals.to(torch.float32),
        indices=payload.indices,
        nnz=torch.full((), meta.k, dtype=torch.int32, device=vals.device),
        shape=shape,
    )


def wire_bits(payload: PolyFitPayload, meta: PolyFitMeta) -> torch.Tensor:
    """Only active segments' coefficients count, plus 32 bits of num_pos;
    the rest of the [S, p] buffer is padding."""
    sizes = segment_sizes(meta.k, payload.num_pos)
    active = (sizes > 0).to(torch.float32).sum()
    return active * (meta.degree + 1) * 32 + 32
