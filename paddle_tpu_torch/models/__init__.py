"""Model definitions: the Transformer LM (``transformer``) and ResNet
(``resnet``)."""

from . import resnet
from .transformer import TransformerLM

__all__ = ["TransformerLM", "resnet"]
