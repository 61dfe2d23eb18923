"""The port's analysis gate, ported from `deepreduce_tpu/analysis/`.

`python -m deepreduce_tpu_torch.analysis` runs the AST lint over the package
and the run-time audit of its traces: a recorder around the collectives
(`recorder.py`) and an op census (`census.py`) held to the rule table
(`rules.py`); `matrix` replays the composition lattice (`lattice.py`)
against the JAX package's committed MATRIX.json, `mem` prints the card's
peak memory of the flagship traces (`memory.py`).
"""

from deepreduce_tpu_torch.analysis.rules import AuditContext, Violation

__all__ = ["AuditContext", "Violation"]
