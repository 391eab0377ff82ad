"""ParamAttr: per-parameter configuration.

Counterpart of ``paddle_tpu/param_attr.py`` (name, initializer,
learning_rate, regularizer, trainable, gradient_clip).
"""

from __future__ import annotations

from typing import Optional

from .initializer import Initializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None,
                 initializer: Optional[Initializer] = None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else ParamAttr(trainable=False)
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
