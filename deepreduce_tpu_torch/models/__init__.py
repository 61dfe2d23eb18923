"""Models of the port, with parameters in the JAX package's flax layout."""

from deepreduce_tpu_torch.models.bert import BertEncoder
from deepreduce_tpu_torch.models.densenet import DenseNet40
from deepreduce_tpu_torch.models.lstm import WordLSTM
from deepreduce_tpu_torch.models.mlp import MLP
from deepreduce_tpu_torch.models.mobilenet import MobileNetV1
from deepreduce_tpu_torch.models.ncf import NeuMF
from deepreduce_tpu_torch.models.resnet import ResNet20, ResNet50
from deepreduce_tpu_torch.models.vgg import VGG16

__all__ = ["BertEncoder", "DenseNet40", "MLP", "MobileNetV1", "NeuMF", "ResNet20", "ResNet50", "VGG16", "WordLSTM"]
