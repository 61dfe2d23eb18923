"""Verbosity-gated debug and metrics dumps, ported from
`deepreduce_tpu/logging_utils.py`.

Reference parity: the C++ `CompressionUtilities` logging layer writes
`fpr.txt`, `policy_errors.txt`, `stats.txt` and full bit-array / value dumps
under ``bloom_logs_path/<rank>/step_<s>/<gradient_id>/``
(compression_utils.hpp:96-176), and the `Logger` TF op dumps the full
gradient (`values.csv`) and the fit coefficients (`coefficients.csv`) per
rank, step and gradient at a verbosity frequency (logger.cc:37-52).

`DumpLogger` keeps that directory scheme, those file names and the JAX
package's line formats, byte for byte. It runs on the host: it takes numpy
arrays or tensors, and moves a tensor to the host with one explicit
`.cpu()` at the call (a copy and, on the card, a sync), never inside a
training step's device work.
"""

from __future__ import annotations

import pathlib
from typing import Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


def _host(x: ArrayLike) -> np.ndarray:
    """A numpy array of `x`: a tensor through one `.cpu()`."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DumpLogger:
    """Per (rank, step, gradient_id) dump directory tree, reference layout."""

    def __init__(self, root: str, rank: int = 0, verbosity: int = 0, frequency: int = 1):
        self.root = pathlib.Path(root)
        self.rank = rank
        self.verbosity = verbosity
        self.frequency = max(1, frequency)

    def enabled(self, step: int) -> bool:
        return self.verbosity > 0 and step % self.frequency == 0

    def _dir(self, step: int, gradient_id: str) -> pathlib.Path:
        path = self.root / str(self.rank) / f"step_{step}" / str(gradient_id)
        path.mkdir(parents=True, exist_ok=True)
        return path

    def log_fpr(self, step: int, gradient_id: str, configured: float, measured: float) -> None:
        """fpr.txt (compression_utils.hpp logging_compressor role)."""
        if not self.enabled(step):
            return
        with open(self._dir(step, gradient_id) / "fpr.txt", "a") as f:
            f.write(f"FalsePositives_Rate: {measured}  (configured: {configured})\n")

    def log_policy_errors(self, step: int, gradient_id: str, errors: int, k: int) -> None:
        """policy_errors.txt: selected indices not in the true set
        (policies.hpp:32-41 get_policy_errors)."""
        if not self.enabled(step):
            return
        with open(self._dir(step, gradient_id) / "policy_errors.txt", "a") as f:
            f.write(f"PolicyErrors: {errors} / {k}\n")

    def log_stats(self, step: int, gradient_id: str, initial_bits: float, final_bits: float) -> None:
        """stats.txt: Initial_Size / Final_Size in bits
        (compression_utils.hpp:145-148)."""
        if not self.enabled(step):
            return
        with open(self._dir(step, gradient_id) / "stats.txt", "a") as f:
            f.write(f"Initial_Size: {int(initial_bits)}   Final_Size: {int(final_bits)}\n")

    def log_values(self, step: int, gradient_id: str, values: ArrayLike) -> None:
        """values.csv: the Logger op's gradient dump (logger.cc:37-52)."""
        if not self.enabled(step):
            return
        np.savetxt(self._dir(step, gradient_id) / "values.csv", _host(values), delimiter=",")

    def log_coefficients(self, step: int, gradient_id: str, coeffs: ArrayLike) -> None:
        """coefficients.csv: the fit-coefficient dump for offline curve
        inspection."""
        if not self.enabled(step):
            return
        np.savetxt(self._dir(step, gradient_id) / "coefficients.csv", _host(coeffs), delimiter=",")


def policy_errors(selected: ArrayLike, true_indices: ArrayLike) -> int:
    """How many selected indices are not true sparsifier indices: the
    diagnostic the C++ policies layer computes (policies.hpp:32-41)."""
    return int(len(np.setdiff1d(_host(selected), _host(true_indices))))
