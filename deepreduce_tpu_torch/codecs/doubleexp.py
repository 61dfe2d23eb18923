"""Double-exponential curve-fit value codec (Fit-DExp), ported from
`deepreduce_tpu/codecs/doubleexp.py`.

The magnitudes, sorted ascending, are fitted by `y = a e^{p x} + c e^{q x}`
on the grid x = i / k, i = 1..k, by the integral method: cumulative
trapezoid integrals S and SS of the curve give a regularised 4x4 system
whose solution yields the exponents (p, q); a 2-column least squares then
gives the amplitudes, each exponential anchored at its own peak (x = 1 when
growing, x = 1/k when decaying) so that no basis value overflows. Only the
4 coefficients cross the wire for the values; the signs ride on the
indices as `(idx + 1) * sign(value)`, in ascending-|value| order.

The solves run on the tensor's own device without a host sync: the 4x4
system by `torch.linalg.solve_ex` (whose unchecked result is the solution,
the jitter making it nonsingular), the least squares as the pseudo-inverse
of its 2x2 Gram matrix in float64 (closed-form eigendecomposition, with the
JAX package's `lstsq` cut-off for small singular values). The sums, the
LU, the exponentials and the least squares round differently from XLA's,
so the coefficients agree with the JAX package's to a tolerance, not
bitwise; the order and the signed indices are bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from deepreduce_tpu_torch.numerics import reciprocal_f32
from deepreduce_tpu_torch.sparse import SparseGrad

_EPS_F32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class DoubleExpMeta:
    k: int


@dataclasses.dataclass(frozen=True)
class DoubleExpPayload:
    coeffs: torch.Tensor  # f32[4] = (a, c, p, q)
    signed_indices: torch.Tensor  # i32[k]: (idx + 1) * sign, ascending |value| (i32[0] once stripped)
    nnz: torch.Tensor  # i32[]

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.coeffs, self.signed_indices, self.nnz)


def grid(k: int, device) -> torch.Tensor:
    """f32[k] x = i / k, i = 1..k, as XLA compiles the divide by a constant:
    i * fl(1/k)."""
    return torch.arange(1, k + 1, dtype=torch.float32, device=device) * reciprocal_f32(k)


def _cumtrapz(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    seg = 0.5 * (f[1:] + f[:-1]) * (x[1:] - x[:-1])
    return torch.cat([torch.zeros(1, dtype=f.dtype, device=f.device), torch.cumsum(seg, 0)])


def _anchor(exponent: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Peak of e^{exponent x} on the grid: x[-1] when growing, x[0] when
    decaying."""
    return torch.where(exponent >= 0, x[-1], x[0])


def _lstsq2(basis: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32[2] least-squares solution of basis [k, 2] @ amp = y with the
    minimum norm: the pseudo-inverse through the eigendecomposition of the
    2x2 Gram matrix in float64, singular values below eps * max(k, 2) times
    the largest dropped, as `jnp.linalg.lstsq` drops them."""
    b = basis.double()
    g11, g22, g12 = (b[:, 0] * b[:, 0]).sum(), (b[:, 1] * b[:, 1]).sum(), (b[:, 0] * b[:, 1]).sum()
    rhs = b.T @ y.double()
    half_gap = torch.sqrt(((g11 - g22) * 0.5) ** 2 + g12 * g12)
    mid = (g11 + g22) * 0.5
    lam = torch.stack([mid + half_gap, torch.clamp(mid - half_gap, min=0.0)])  # descending
    # eigenvector of the larger eigenvalue, then its orthogonal complement
    v1 = torch.where(
        g11 >= g22,
        torch.stack([lam[0] - g22, g12]),
        torch.stack([g12, lam[0] - g11]),
    )
    n1 = torch.sqrt((v1 * v1).sum())
    e1 = (torch.arange(2, device=b.device) == 0).double()
    v1 = torch.where(n1 > 0, v1 / torch.where(n1 > 0, n1, 1.0), e1)
    v = torch.stack([v1, torch.stack([-v1[1], v1[0]])], dim=1)  # columns: eigenvectors
    s = torch.sqrt(lam)
    keep = (s > 0) & (s >= _EPS_F32 * max(basis.shape[0], 2) * s[0])
    inv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
    return (v @ (inv * (v.T @ rhs))).float()


def _fit(y: torch.Tensor) -> torch.Tensor:
    k = y.shape[0]
    dev = y.device
    x = grid(k, dev)
    s = _cumtrapz(y, x)
    ss = _cumtrapz(s, x)
    rows = [ss, s, x]
    upper = {(i, j): (rows[i] * rows[j]).sum() for i in range(3) for j in range(i, 3)}
    upper.update({(i, 3): rows[i].sum() for i in range(3)})
    upper[3, 3] = torch.full((), float(k), dtype=torch.float32, device=dev)
    a = torch.stack([upper[min(i, j), max(i, j)] for i in range(4) for j in range(4)]).reshape(4, 4)
    b = torch.stack([(ss * y).sum(), (s * y).sum(), (x * y).sum(), y.sum()])
    tr = a.diagonal().sum()
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    sol = torch.linalg.solve_ex(a + 1e-7 * tr * eye / 4.0, b[:, None]).result[:, 0]

    disc = torch.clamp(sol[1] * sol[1] + 4.0 * sol[0], min=0.0)
    root = torch.sqrt(disc)
    p = torch.clamp(0.5 * (sol[1] + root), -80.0, 80.0)
    q = torch.clamp(0.5 * (sol[1] - root), -80.0, 80.0)
    beta = torch.exp(p * (x - _anchor(p, x)))
    eta = torch.exp(q * (x - _anchor(q, x)))
    nb = torch.sqrt((beta * beta).sum())
    ne = torch.sqrt((eta * eta).sum())
    amp = _lstsq2(torch.stack([beta / nb, eta / ne], dim=1), y)
    return torch.stack([amp[0] / nb, amp[1] / ne, p, q])


def _eval(coeffs: torch.Tensor, k: int) -> torch.Tensor:
    x = grid(k, coeffs.device)
    a, c, p, q = coeffs[0], coeffs[1], coeffs[2], coeffs[3]
    return a * torch.exp(p * (x - _anchor(p, x))) + c * torch.exp(q * (x - _anchor(q, x)))


def encode(sp: SparseGrad, meta: DoubleExpMeta) -> DoubleExpPayload:
    mags = sp.values.abs()
    order = torch.sort(mags, stable=True).indices  # ascending |value|
    y = mags[order]
    idx1 = sp.indices[order].to(torch.int32) + 1
    signed = idx1 * torch.sign(sp.values[order]).to(torch.int32)
    signed = torch.where(signed == 0, idx1, signed)  # a zero value keeps +
    return DoubleExpPayload(coeffs=_fit(y), signed_indices=signed, nnz=sp.nnz.to(torch.int32))


def decode(payload: DoubleExpPayload, meta: DoubleExpMeta, shape: Tuple[int, ...]) -> SparseGrad:
    y = _eval(payload.coeffs, meta.k)
    sign = torch.sign(payload.signed_indices).to(torch.float32)
    idxs = payload.signed_indices.abs() - 1
    return SparseGrad(values=y * sign, indices=torch.clamp(idxs, min=0).to(torch.int32), nnz=payload.nnz, shape=shape)


def wire_bits(payload: DoubleExpPayload, meta: DoubleExpMeta) -> torch.Tensor:
    """The values' side: 4 float32 coefficients."""
    return torch.full((), 4.0 * 32, dtype=torch.float32, device=payload.coeffs.device)
