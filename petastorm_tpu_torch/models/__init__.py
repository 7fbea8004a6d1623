"""Models of the port: ResNet and its SGD train step."""

from petastorm_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50, ResNetTiny  # noqa: F401
from petastorm_tpu_torch.models.train import create_train_state, make_train_step  # noqa: F401
