"""Heterogeneous non-IID client populations for the federated serving path,
ported from `deepreduce_tpu/population/`.

`PopulationSpec` (spec.py) is the schema-validated, version-tagged class
table: every client in the `[num_clients, ...]` residual bank belongs to one
class carrying three heterogeneity axes: data skew (a Dirichlet label
concentration per class driving the non-IID synthetic-data transform), a
latency class (a per-class staleness distribution for the async tick) and a
compute class (a local-step multiplier the cost model prices). sampler.py
derives everything on the device from the spec's seed alone: class
assignments, per-client label mixtures and the batch transform.
"""

from deepreduce_tpu_torch.population.sampler import (
    class_assignments,
    class_counts,
    concentration_table,
    expected_marginals,
    label_means,
    label_mixtures,
    make_population_data_fn,
)
from deepreduce_tpu_torch.population.spec import ClassSpec, PopulationSpec

__all__ = [
    "ClassSpec",
    "PopulationSpec",
    "class_assignments",
    "class_counts",
    "concentration_table",
    "expected_marginals",
    "label_means",
    "label_mixtures",
    "make_population_data_fn",
]
