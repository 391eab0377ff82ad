"""Metric layers.

Counterpart of ``paddle_tpu/layers/metric.py`` ``accuracy``; ``auc`` is
not ported.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    """The fraction of samples whose top-k predictions hold the label."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_tmp_variable("float32")
    correct = correct or helper.create_tmp_variable("int32")
    total = total or helper.create_tmp_variable("int32")
    for v in (acc_out, correct, total):
        v.stop_gradient = True
    helper.append_op("accuracy",
                     {"Out": topk_out, "Indices": topk_indices, "Label": label},
                     {"Accuracy": acc_out, "Correct": correct, "Total": total})
    return acc_out
