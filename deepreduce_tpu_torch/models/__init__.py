"""Models of the port, with parameters in the JAX package's flax layout."""

from deepreduce_tpu_torch.models.lstm import WordLSTM
from deepreduce_tpu_torch.models.mobilenet import MobileNetV1
from deepreduce_tpu_torch.models.ncf import NeuMF
from deepreduce_tpu_torch.models.resnet import ResNet20

__all__ = ["MobileNetV1", "NeuMF", "ResNet20", "WordLSTM"]
