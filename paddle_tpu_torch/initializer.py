"""Parameter initializers as startup-program ops.

Counterpart of ``paddle_tpu/initializer.py`` (``Constant``, ``Uniform``,
``Normal``, ``Xavier``): each appends an init op (fill_constant /
uniform_random / gaussian_random) that writes the persistable var in the
startup program.
"""

from __future__ import annotations

import math

from .core.program import Block, VarDesc

__all__ = ["Initializer", "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "XavierInitializer", "Constant", "Uniform",
           "Normal", "Xavier"]


class Initializer:
    def __call__(self, var: VarDesc, block: Block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", {}, {"Out": var.name},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", {}, {"Out": var.name},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", {}, {"Out": var.name},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "mean": self.loc, "std": self.scale, "seed": self.seed})


def _fan_in_out(var: VarDesc):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot init."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None, seed: int = 0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
