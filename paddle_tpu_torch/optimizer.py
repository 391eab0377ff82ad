"""Optimizers: minimize = append_backward + accumulators + update ops.

Counterpart of ``paddle_tpu/optimizer.py`` (``Optimizer``,
``SGDOptimizer``, ``AdamOptimizer``). ``minimize`` appends the backward
boundary, the gradient clip and regularization ops, then one update op
per parameter; accumulators are persistable vars initialized by the
startup program, under the JAX package's names. Gradient clipping,
weight decay, bf16 moments (``PT_OPT_STATE_DTYPE``) and the step guard
(``PT_GUARD``) are not ported and raise.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .backward import append_backward
from .core.program import VarDesc, default_main_program, unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGDOptimizer", "AdamOptimizer", "SGD", "Adam",
           "append_gradient_clip_ops", "append_regularization_ops"]

_OFF = ("", "0", "off", "none", "false")


def append_gradient_clip_ops(param_grads: List[Tuple[VarDesc, VarDesc]]):
    """The identity while no parameter carries a clip attr; clipping is
    not ported."""
    for p, _ in param_grads:
        if getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(f"gradient clipping (on {p.name!r}) "
                                      "is not ported")
    return param_grads


def append_regularization_ops(param_grads, regularization=None):
    """The identity while no regularizer is set; weight decay is not
    ported."""
    for p, g in param_grads:
        if g is not None and (getattr(p, "regularizer", None)
                              or regularization) is not None:
            raise NotImplementedError(f"regularization (of {p.name!r}) is "
                                      "not ported")
    return param_grads


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, VarDesc)):
            raise TypeError("learning_rate must be float or Variable")
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map: Dict[int, VarDesc] = {}
        self._accumulators: Dict[str, Dict[str, VarDesc]] = defaultdict(dict)
        self.helper: Optional[LayerHelper] = None

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        prog = default_main_program()
        if id(prog) in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, VarDesc):
            self._learning_rate_map[id(prog)] = self._learning_rate
            return
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            name=unique_name("learning_rate"), dtype="float32", shape=(1,),
            persistable=True)
        lr.stop_gradient = True
        helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[id(prog)] = lr

    def _global_learning_rate(self) -> VarDesc:
        return self._learning_rate_map[id(default_main_program())]

    def _create_param_lr(self, param_and_grad):
        """Per-parameter learning-rate multipliers are not ported."""
        param = param_and_grad[0]
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult != 1.0:
            raise NotImplementedError(
                f"ParamAttr(learning_rate={mult}) on {param.name!r}: "
                "per-parameter learning rates are not ported")
        return self._global_learning_rate()

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name: str, param: VarDesc, dtype=None,
                         fill_value: float = 0.0, shape=None) -> VarDesc:
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = self.helper or LayerHelper("optimizer")
        var = helper.create_global_variable(
            name=unique_name(f"{param.name}_{name}"),
            dtype=dtype or param.dtype,
            shape=tuple(shape) if shape is not None else param.shape,
            persistable=True)
        var.stop_gradient = True
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks for subclasses ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the optimization pass ----------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads):
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        block = default_main_program().global_block
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        return [self._append_optimize_op(block, pg)
                for pg in parameters_and_grads
                if pg[1] is not None and pg[0].trainable]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if os.environ.get("PT_GUARD", "").strip().lower() not in _OFF:
            raise NotImplementedError("PT_GUARD (the guarded update) is not "
                                      "ported; unset it")
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            "sgd",
            {"Param": param_and_grad[0], "Grad": param_and_grad[1],
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": param_and_grad[0]})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        if os.environ.get("PT_OPT_STATE_DTYPE", "").strip().lower() not in \
                _OFF + ("float32", "f32", "fp32"):
            raise NotImplementedError("PT_OPT_STATE_DTYPE (low-precision "
                                      "moments) is not ported; unset it")
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            {"Param": p, "Grad": param_and_grad[1],
             "LearningRate": self._create_param_lr(param_and_grad),
             "Moment1": m1, "Moment2": m2, "Beta1Pow": b1p, "Beta2Pow": b2p},
            {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})


SGD = SGDOptimizer
Adam = AdamOptimizer
