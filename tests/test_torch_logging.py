"""The port's `logging_utils` (`DumpLogger`, `policy_errors`) against the
JAX package's `tests/test_logging.py` cases: the same calls on the same
inputs write the same tree, every file byte-equal to JAX's, and the port
takes tensors where JAX takes arrays."""

import pathlib

import jax.numpy as jnp
import numpy as np
import torch

from deepreduce_tpu.codecs import bloom as jax_bloom
from deepreduce_tpu.logging_utils import DumpLogger as JaxDumpLogger
from deepreduce_tpu.logging_utils import policy_errors as jax_policy_errors
from deepreduce_tpu.sparse import SparseGrad as JaxSparseGrad
from deepreduce_tpu_torch import DumpLogger, policy_errors
from deepreduce_tpu_torch.codecs import bloom
from deepreduce_tpu_torch.sparse import SparseGrad


def _tree(root: pathlib.Path) -> dict:
    """Every file under `root` by relative path, as bytes."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_dump_tree_layout_and_contents(tmp_path):
    for logger, root, values, coeffs in (
        (JaxDumpLogger, tmp_path / "jax", np.arange(4, dtype=np.float32), np.ones((2, 3))),
        (DumpLogger, tmp_path / "port", torch.arange(4, dtype=torch.float32), torch.ones((2, 3), dtype=torch.float64)),
    ):
        log = logger(str(root), rank=3, verbosity=1, frequency=2)
        log.log_fpr(0, "conv1", configured=0.01, measured=0.012)
        log.log_policy_errors(0, "conv1", errors=5, k=100)
        log.log_stats(0, "conv1", initial_bits=32000, final_bits=4000)
        log.log_values(0, "conv1", values)
        log.log_coefficients(0, "conv1", coeffs)
        # appended lines, not a fresh file a call
        log.log_fpr(2, "conv1", configured=0.01, measured=0.0)
        log.log_fpr(2, "conv1", configured=0.01, measured=1e-7)

    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) == [
        "3/step_0/conv1/coefficients.csv", "3/step_0/conv1/fpr.txt", "3/step_0/conv1/policy_errors.txt",
        "3/step_0/conv1/stats.txt", "3/step_0/conv1/values.csv", "3/step_2/conv1/fpr.txt",
    ]
    assert got == want
    d = tmp_path / "port" / "3" / "step_0" / "conv1"
    assert (d / "fpr.txt").read_text().startswith("FalsePositives_Rate: 0.012")
    assert "PolicyErrors: 5 / 100" in (d / "policy_errors.txt").read_text()
    assert "Initial_Size: 32000" in (d / "stats.txt").read_text()
    assert len((d / "values.csv").read_text().strip().splitlines()) == 4
    assert len((d / "coefficients.csv").read_text().strip().splitlines()) == 2


def test_frequency_and_verbosity_gating(tmp_path):
    log = DumpLogger(str(tmp_path), rank=0, verbosity=1, frequency=2)
    log.log_fpr(1, "g", 0.01, 0.01)  # step 1 % 2 != 0 -> gated
    log.log_values(3, "g", torch.ones(2))
    assert not (tmp_path / "0" / "step_1").exists() and not (tmp_path / "0" / "step_3").exists()

    off = DumpLogger(str(tmp_path), rank=0, verbosity=0)
    off.log_fpr(0, "g", 0.01, 0.01)  # verbosity 0 -> everything gated
    off.log_coefficients(0, "g", torch.ones(2))
    assert not (tmp_path / "0" / "step_0").exists()
    # frequency below 1 counts as 1, as in the JAX package
    assert DumpLogger(str(tmp_path), verbosity=1, frequency=0).frequency == JaxDumpLogger(
        str(tmp_path), verbosity=1, frequency=0).frequency == 1


def test_policy_errors_diagnostic():
    selected = np.array([1, 5, 9, 12])
    true_idx = np.array([1, 5, 7])
    assert policy_errors(selected, true_idx) == jax_policy_errors(selected, true_idx) == 2  # 9 and 12 are not true
    assert policy_errors(torch.tensor([1, 5, 9, 12, 9]), torch.tensor([1, 5, 7])) == 2
    assert policy_errors(torch.tensor([3]), np.array([3])) == 0


def test_measured_fpr_feeds_logger(tmp_path):
    d, k = 4096, 128
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(d, size=k, replace=False)).astype(np.int32)

    jsp = JaxSparseGrad(values=jnp.ones((k,), jnp.float32), indices=jnp.asarray(idx),
                        nnz=jnp.asarray(k, jnp.int32), shape=(d,))
    jmeta = jax_bloom.BloomMeta.create(k, d, fpr=0.05, policy="p0")
    jmeasured = float(jax_bloom.measured_fpr(jsp, jax_bloom.insert(jsp.indices, jsp.nnz, jmeta), jmeta))

    sp = SparseGrad(values=torch.ones(k), indices=torch.from_numpy(idx), nnz=torch.tensor(k, dtype=torch.int32),
                    shape=(d,))
    meta = bloom.BloomMeta.create(k, d, fpr=0.05, policy="p0")
    measured = float(bloom.measured_fpr(sp, bloom.insert(sp.indices, sp.nnz, meta), meta))
    assert measured == jmeasured
    assert 0.0 <= measured < 0.25  # calibrated well above configured is a bug

    DumpLogger(str(tmp_path / "port"), rank=0, verbosity=1).log_fpr(0, "g0", configured=0.05, measured=measured)
    JaxDumpLogger(str(tmp_path / "jax"), rank=0, verbosity=1).log_fpr(0, "g0", configured=0.05, measured=jmeasured)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert "configured: 0.05" in (tmp_path / "port" / "0" / "step_0" / "g0" / "fpr.txt").read_text()
