"""Count-sketch value codec (summable, lossy), ported from
`deepreduce_tpu/codecs/countsketch.py`.

A count sketch is a [rows, cols] float32 table: coordinate i with value v
adds `s_r(i) * v` to column `h_r(i)` of every row r, and a coordinate is
read back as the median over the rows of `sketch[r, h_r(i)] * s_r(i)`.
The hashes are multiplicative uint32 hashes with odd constants derived
from (seed, row), computed in int64 through `u32.mul_lo`, bitwise the JAX
package's.

Each row's column sums are one scatter-add (`index_add_`). On the CPU it
adds a column's entries in slot order from zero, the order of the JAX
package's scatter-add, so the sketch is bitwise the JAX package's; on the
card the atomics land in their own order, which agrees with the CPU to
rounding. The median of an even row count averages the two middle rows
(`torch.median` would take the lower one).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from deepreduce_tpu_torch import u32
from deepreduce_tpu_torch.sparse import SparseGrad

# Knuth / Murmur odd mixing constants: an odd multiple stays odd mod 2**32
_PHI32 = 0x9E3779B1
_MURMUR32 = 0x85EBCA77


def row_constants(rows: int, seed: int = 0) -> List[Tuple[int, int]]:
    """Static (bucket, sign) multipliers of each sketch row."""
    out = []
    for r in range(rows):
        odd = 2 * (seed + r) + 1
        out.append(((_PHI32 * odd) & u32.MASK32, (_MURMUR32 * odd) & u32.MASK32))
    return out


def _bucket(idx: torch.Tensor, mult: int, cols: int) -> torch.Tensor:
    return (u32.mul_lo(idx, mult) >> 16) % cols


def _sign(idx: torch.Tensor, mult: int) -> torch.Tensor:
    return 1.0 - 2.0 * (u32.mul_lo(idx, mult) >> 31).to(torch.float32)


def _column_sums(column: torch.Tensor, vals: torch.Tensor, cols: int) -> torch.Tensor:
    """f32[cols]: the sum of `vals` landing in each column."""
    return torch.zeros(cols, dtype=vals.dtype, device=vals.device).index_add_(0, column, vals)


def sketch_from_sparse(values: torch.Tensor, indices: torch.Tensor, rows: int, cols: int, *, seed: int = 0) -> torch.Tensor:
    """f32[rows, cols] sketch of a k-sparse vector (dead slots must carry
    value 0): rows column sums of k entries each, never O(d)."""
    idx = indices.to(torch.int64) & u32.MASK32
    planes = [
        _column_sums(_bucket(idx, a_mult, cols), values * _sign(idx, b_mult), cols)
        for a_mult, b_mult in row_constants(rows, seed)
    ]
    return torch.stack(planes)


def _median_rows(stacked: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 with a static row count: the middle row, or the
    mean of the two middle rows for an even count."""
    rows = stacked.shape[0]
    srt = torch.sort(stacked, dim=0).values
    return 0.5 * (srt[(rows - 1) // 2] + srt[rows // 2])


def unsketch_at(sketch: torch.Tensor, indices: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Median-of-rows point queries at `indices`."""
    rows, cols = sketch.shape
    idx = indices.to(torch.int64) & u32.MASK32
    ests = [sketch[r][_bucket(idx, a, cols)] * _sign(idx, b) for r, (a, b) in enumerate(row_constants(rows, seed))]
    return _median_rows(torch.stack(ests))


@dataclasses.dataclass(frozen=True)
class CountSketchMeta:
    k: int
    rows: int = 5
    cols: int = 2048
    seed: int = 0

    @property
    def table_size(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class CountSketchPayload:
    sketch: torch.Tensor  # f32[rows, cols]: payloads sum coordinate-wise
    indices: torch.Tensor  # i32[k], the selection passed through (i32[0] once stripped)
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.sketch, self.indices, self.nnz)


def encode(sp: SparseGrad, meta: CountSketchMeta) -> CountSketchPayload:
    live = torch.arange(meta.k, device=sp.values.device) < sp.nnz
    vals = torch.where(live, sp.values, torch.zeros((), dtype=sp.values.dtype, device=sp.values.device))
    sk = sketch_from_sparse(vals, sp.indices, meta.rows, meta.cols, seed=meta.seed)
    return CountSketchPayload(sketch=sk, indices=sp.indices, nnz=sp.nnz)


def decode(payload: CountSketchPayload, meta: CountSketchMeta, shape: Tuple[int, ...]) -> SparseGrad:
    est = unsketch_at(payload.sketch, payload.indices, seed=meta.seed)
    live = torch.arange(meta.k, device=est.device) < payload.nnz
    vals = torch.where(live, est, torch.zeros((), dtype=est.dtype, device=est.device))
    return SparseGrad(values=vals, indices=payload.indices, nnz=payload.nnz, shape=shape)


def wire_bits(payload: CountSketchPayload, meta: CountSketchMeta) -> torch.Tensor:
    """The whole float32 table, whatever nnz: the price of summability."""
    return torch.full((), float(meta.table_size * 32), dtype=torch.float32, device=payload.sketch.device)
