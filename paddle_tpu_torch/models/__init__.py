"""Model definitions: the Transformer LM (``transformer``), ResNet
(``resnet``) and the stacked dynamic LSTM (``stacked_dynamic_lstm``)."""

from . import resnet, stacked_dynamic_lstm
from .transformer import TransformerLM

__all__ = ["TransformerLM", "resnet", "stacked_dynamic_lstm"]
