"""Float32 arithmetic as the JAX package's compiled programs do it.

XLA rewrites a divide by a constant into a multiply by the constant's
float32 reciprocal (`x / q` becomes `x * fl(1/q)`), which differs from an
IEEE divide in the last bit of some values. The port writes every such
divide as that multiply, on the CPU and the card alike: a multiply is one
rounding on both, so the two agree bitwise, and both agree with the JAX
package's jitted step (the QSGD decode's `norms / q`, every mean's `/ W`).
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
