"""Models of the port, with parameters in the JAX package's flax layout."""

from deepreduce_tpu_torch.models.lstm import WordLSTM
from deepreduce_tpu_torch.models.resnet import ResNet20

__all__ = ["ResNet20", "WordLSTM"]
