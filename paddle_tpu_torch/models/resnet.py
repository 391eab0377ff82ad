"""ResNet for ImageNet and cifar10: conv-BN blocks, basic (18/34) and
bottleneck (50/101/152) residual blocks.

Counterpart of ``paddle_tpu/models/resnet.py``, call for call, so that
the same calls give the same program and var names in both packages.
Stride-1 rest bottlenecks are one ``fused_bottleneck`` op unless
``PT_FUSED_BLOCK`` is never or 0; the Executor's fusion pass turns every
other conv + BN (+ add) (+ ReLU) chain into ``fused_conv2d``.
``get_model`` builds a float32 program or, as the bench trains it on the
accelerator, a bfloat16 one: the ``data`` var is bfloat16, the
parameters float32 masters (layer_helper's rule), and every op computes
in its input's dtype with the weights cast to it. Another ``dtype``
raises at build time.
"""

from __future__ import annotations

import os

from .. import layers, optimizer

__all__ = ["conv_bn_layer", "shortcut", "basicblock", "bottleneck",
           "layer_warp", "resnet_imagenet", "resnet_cifar10", "get_model"]


def _use_fused_block() -> bool:
    """Emit the one-op fused bottleneck for stride-1 rest blocks, in
    train and inference graphs alike (they share parameter names);
    PT_FUSED_BLOCK=never builds the op-by-op graph."""
    return os.environ.get("PT_FUSED_BLOCK", "auto") not in ("0", "never")


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None, is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    if stride == 1 and input.shape[1] == ch_out * 4 and _use_fused_block():
        return layers.fused_bottleneck(input, ch_out, is_test=is_test)
    short = shortcut(input, ch_out * 4, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_out, stride, is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test)
    return res_out


_CFG = {
    18: ([2, 2, 2, 1], basicblock),
    34: ([3, 4, 6, 3], basicblock),
    50: ([3, 4, 6, 3], bottleneck),
    101: ([3, 4, 23, 3], bottleneck),
    152: ([3, 8, 36, 3], bottleneck),
}


def resnet_imagenet(input, class_dim, depth=50, is_test=False,
                    head_act="softmax"):
    stages, block_func = _CFG[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_test)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_test)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_test)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act=head_act)


def resnet_cifar10(input, class_dim, depth=32, is_test=False,
                   head_act="softmax"):
    if (depth - 2) % 6:
        raise ValueError(f"resnet_cifar10 depth {depth}: depth - 2 must be a "
                         "multiple of 6")
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act=head_act)


def get_model(data_set: str = "flowers", depth: int = 50,
              learning_rate: float = 0.01, is_test: bool = False,
              dtype: str = "float32", fused_xent: bool = False):
    """The training program of the benchmark: (avg_cost, batch accuracy,
    predictions, feed names). fused_xent: logits into
    softmax_with_cross_entropy instead of a softmax head into
    cross_entropy. Momentum 0.9 at `learning_rate`. dtype: float32, or
    bfloat16 (the data var's dtype; float32 masters)."""
    if dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"resnet.get_model(dtype={dtype!r}): the "
                                  "port trains float32 and bfloat16 "
                                  "programs; this dtype is not ported")
    if data_set == "cifar10":
        class_dim, shape = 10, [3, 32, 32]
        model = resnet_cifar10
        depth = 32 if depth == 50 else depth
    else:
        class_dim = 102 if data_set == "flowers" else 1000
        shape = [3, 224, 224]
        model = resnet_imagenet

    input = layers.data("data", shape, dtype=dtype)
    label = layers.data("label", [1], dtype="int64")
    if fused_xent:
        logits = model(input, class_dim, depth=depth, is_test=is_test,
                       head_act=None)
        predict = layers.softmax(logits)
        cost = layers.softmax_with_cross_entropy(logits, label)
    else:
        predict = model(input, class_dim, depth=depth, is_test=is_test)
        cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    batch_acc = layers.accuracy(input=predict, label=label)
    opt = optimizer.MomentumOptimizer(learning_rate=learning_rate,
                                      momentum=0.9)
    opt.minimize(avg_cost)
    return avg_cost, batch_acc, predict, ["data", "label"]
