"""Optimizers: minimize = append_backward + accumulators + update ops.

Counterpart of ``paddle_tpu/optimizer.py`` (``Optimizer``,
``SGDOptimizer``, ``MomentumOptimizer``, ``AdamOptimizer``).
``minimize`` appends, in the JAX package's order, the backward boundary
(with ``clip.error_clip_callback``), the gradient clip ops (clip.py),
the weight-decay ops (regularizer.py), one update op per parameter and
``_finish_update``, then, with ``PT_GUARD`` set, the ``step_health`` op
(resilience/guard.py). Accumulators are persistable vars initialized by
the startup program, under the JAX package's names; with
``PT_OPT_STATE_DTYPE=bfloat16`` the parameter-shaped moments are stored
in bfloat16 while the update ops compute in float32. A parameter's
``ParamAttr(learning_rate=m)`` becomes a ``scale`` op on the global
rate. Adagrad, RMSProp and the other optimizers are not ported.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .core.program import VarDesc, default_main_program, unique_name
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .resilience.guard import maybe_instrument

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
           "SGD", "Momentum", "Adam"]


def _opt_state_dtype() -> Optional[str]:
    """PT_OPT_STATE_DTYPE: the dtype of the parameter-shaped moment
    accumulators (Adam's m and v, Momentum's velocity). 'bfloat16'
    halves their memory; the update math stays float32 in the ops and
    the parameters stay float32. Unset or float32: float32. The scalar
    beta-power accumulators always stay float32."""
    raw = os.environ.get("PT_OPT_STATE_DTYPE", "").strip().lower()
    if raw in ("", "0", "off", "float32", "f32", "fp32"):
        return None
    if raw in ("bfloat16", "bf16"):
        return "bfloat16"
    raise ValueError(f"malformed PT_OPT_STATE_DTYPE={raw!r}: expected "
                     "bfloat16 (or unset/float32)")


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
        """The parameter's rate: the global rate, or a `scale` op on it
        for a ParamAttr(learning_rate=m) multiplier."""
        param = param_and_grad[0]
        base = self._global_learning_rate()
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return base
        helper = LayerHelper("param_lr")
        out = helper.create_tmp_variable("float32")
        out.stop_gradient = True
        helper.append_op("scale", {"X": base}, {"Out": out},
                         {"scale": float(mult)})
        return out

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

    def _finish_update(self, block):
        pass

    # -- the optimization pass ----------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads):
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        block = default_main_program().global_block
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        optimize_ops = [self._append_optimize_op(block, pg)
                        for pg in parameters_and_grads
                        if pg[1] is not None and pg[0].trainable]
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads)
        # with PT_GUARD set, the step-health op over the raw @GRAD
        # bindings (placed right after the backward boundary)
        maybe_instrument(default_main_program())
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


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        moment_dt = _opt_state_dtype()
        for p in parameters:
            self._add_accumulator(
                self._velocity_acc_str, p,
                dtype=moment_dt if str(p.dtype) == "float32" else None)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            "momentum",
            {"Param": param_and_grad[0], "Grad": param_and_grad[1],
             "Velocity": velocity,
             "LearningRate": self._create_param_lr(param_and_grad)},
            {"ParamOut": param_and_grad[0], "VelocityOut": velocity},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        moment_dt = _opt_state_dtype()
        for p in parameters:
            dt = moment_dt if str(p.dtype) == "float32" else None
            self._add_accumulator(self._moment1_acc_str, p, dtype=dt)
            self._add_accumulator(self._moment2_acc_str, p, dtype=dt)
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
Momentum = MomentumOptimizer
Adam = AdamOptimizer
