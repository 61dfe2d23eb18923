"""Float32 arithmetic as the JAX package's compiled programs do it.

XLA rewrites a divide by a constant into a multiply by the constant's
float32 reciprocal (`x / q` becomes `x * fl(1/q)`), which differs from an
IEEE divide in the last bit of some values. The port writes every such
divide as that multiply, on the CPU and the card alike: a multiply is one
rounding on both, so the two agree bitwise, and both agree with the JAX
package's jitted step (the QSGD decode's `norms / q`, every mean's `/ W`).

XLA:CPU also contracts a multiply feeding an add into one fused
multiply-add (PolyFit's Legendre recurrence and Tikhonov jitter):
`fma_f32` rounds such a site once, as the JAX package's jitted program
does.
"""

from __future__ import annotations

import numpy as np
import torch


def reciprocal_f32(x: int) -> float:
    """1 / x rounded to float32: XLA's rewrite of a divide by a constant."""
    return float(np.float32(1.0) / np.float32(x))


def mean_of_sum(total: torch.Tensor, count: int) -> torch.Tensor:
    """`total / count` as XLA computes it: `total * fl(1/count)`."""
    return total * reciprocal_f32(count)


def fma_f32(a, b, c) -> torch.Tensor:
    """fl(a * b + c) with one rounding: the float32 fused multiply-add that
    XLA:CPU contracts `a * b + c` into in a jitted program.

    Written in plain float64 arithmetic, so the CPU and the card give the
    same bits: the product of two float32 values is exact in float64; the
    sum `s = p + c` rounds once, and its error `e` (TwoSum) says on which
    side of `s` the exact sum lies. Rounding to odd (the neighbour of `s`
    toward `e` when `s` is even and `e` is nonzero) keeps a sticky bit, so
    the final cast to float32 rounds the exact value correctly (53 >= 2 *
    24 + 2 bits). Tensors or Python floats (taken as float32) in, float32
    out."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (
        x.double() if isinstance(x, torch.Tensor) else torch.full((), float(np.float32(x)), dtype=torch.float64,
                                                                  device=ref.device)
        for x in (a, b, c)
    )
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf"))))
    return torch.where((e != 0) & even, toward, s).float()
