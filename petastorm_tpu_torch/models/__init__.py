"""Models of the port: ResNet, ViT, MLP, TransformerLM (with optional Switch
MoE layers) and their SGD train steps."""

from petastorm_tpu_torch.models.mlp import MLP  # noqa: F401
from petastorm_tpu_torch.models.moe import SwitchMoE, moe_aux_loss  # noqa: F401
from petastorm_tpu_torch.models.resnet import ResNet, ResNet18, ResNet50, ResNetTiny  # noqa: F401
from petastorm_tpu_torch.models.train import (ScanStep, create_train_state,  # noqa: F401
                                              make_eval_step, make_lm_scan_train_step,
                                              make_lm_train_step, make_scan_train_step,
                                              make_train_step)
from petastorm_tpu_torch.models.transformer import TransformerLM  # noqa: F401
from petastorm_tpu_torch.models.vit import ViT, ViTTiny  # noqa: F401
