"""Stacked dynamic LSTM text classifier (BASELINE config 4).

Counterpart of ``paddle_tpu/models/stacked_dynamic_lstm.py``: embedding
-> tanh fc -> fc to the four gates -> ``dynamic_lstm`` -> last-step
pool -> softmax fc, with Adam. The fused form (``use_fused=True``, one
``dynamic_lstm`` op, which the bench trains) is ported; the
reference's hand-built cell inside ``DynamicRNN`` (``use_fused=False``)
needs the sub-block scanner, which is not ported.
"""

from __future__ import annotations

from .. import layers, optimizer

__all__ = ["lstm_net", "get_model"]


def lstm_net(data, dict_size: int, lstm_size: int = 512, emb_dim: int = 512,
             use_fused: bool = False):
    if not use_fused:
        raise NotImplementedError(
            "stacked_dynamic_lstm with use_fused=False (the DynamicRNN "
            "cell) is not ported; build it with use_fused=True")
    sentence = layers.embedding(input=data, size=[dict_size, emb_dim])
    sentence = layers.fc(input=sentence, size=lstm_size, act="tanh")
    proj = layers.fc(input=sentence, size=lstm_size * 4)
    hidden, _ = layers.dynamic_lstm(proj, size=lstm_size * 4,
                                    use_peepholes=False)
    return layers.sequence_pool(hidden, "last")


def get_model(dict_size: int = 30000, lstm_size: int = 512,
              emb_dim: int = 512, use_fused: bool = False):
    """(loss, batch accuracy, softmax output, feed names)."""
    data = layers.data(name="words", shape=[1], lod_level=1, dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    last = lstm_net(data, dict_size, lstm_size, emb_dim, use_fused)
    logit = layers.fc(input=last, size=2, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=logit, label=label))
    batch_acc = layers.accuracy(input=logit, label=label)
    adam = optimizer.AdamOptimizer(learning_rate=0.001)
    adam.minimize(loss)
    return loss, batch_acc, logit, ["words", "label"]
