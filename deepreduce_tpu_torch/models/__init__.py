"""Models of the port, with parameters in the JAX package's flax layout."""

from deepreduce_tpu_torch.models.lstm import WordLSTM

__all__ = ["WordLSTM"]
