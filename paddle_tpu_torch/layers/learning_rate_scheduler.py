"""Learning-rate schedules as program ops.

Counterpart of ``paddle_tpu/layers/learning_rate_scheduler.py``:
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay and noam_decay. Each builds, in the
main program, the ops that compute the rate from a persistable float32
step counter (``@LR_DECAY_COUNTER@``) that an ``increment`` op advances
once a run; the counter is saved and restored with the other
persistables, so a resumed run continues its schedule.
"""

from __future__ import annotations

import math

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "global_step_counter", "autoincreased_step_counter"]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def global_step_counter():
    """The persistable float32 step counter, incremented once a run (one
    var and one increment op a program, however many schedules read
    it)."""
    helper = LayerHelper("global_step_counter")
    block = helper.main_program.global_block
    if _COUNTER_NAME in block.vars:
        return block.vars[_COUNTER_NAME]
    counter = helper.create_global_variable(
        name=_COUNTER_NAME, dtype="float32", shape=(1,), persistable=True)
    counter.stop_gradient = True
    helper.set_variable_initializer(counter, ConstantInitializer(0.0))
    helper.append_op("increment", {"X": counter}, {"Out": counter},
                     {"step": 1.0})
    return counter


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return _scale_pow(learning_rate, decay_rate, div)


def _scale_pow(lr, rate, exponent):
    """lr * rate^exponent as exp(log(rate) * exponent)."""
    scaled = exponent * math.log(rate)
    return ops.exp(scaled) * lr


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return ops.exp(div * (-decay_rate)) * learning_rate


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return (div * decay_rate + 1.0).__rtruediv__(1.0) * learning_rate


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = global_step_counter()
    if cycle:
        div = ops.ceil(step / float(decay_steps))
        # max(div, 1): no zero divisor at step 0
        one = tensor.fill_constant([1], "float32", 1.0)
        div = nn.elementwise_max(div, one)
        frac = step / (div * float(decay_steps))
    else:
        cap = tensor.fill_constant([1], "float32", float(decay_steps))
        frac = nn.elementwise_min(step, cap) * (1.0 / float(decay_steps))
    return ((1.0 - frac) ** float(power)
            * (learning_rate - end_learning_rate) + end_learning_rate)


def piecewise_decay(boundaries, values):
    """Piecewise-constant rate: the indicators of each interval, times
    its value, summed (no branch)."""
    assert len(values) == len(boundaries) + 1
    step = global_step_counter()
    lr = None
    for i, v in enumerate(values):
        if i == 0:
            indicator = _step_less_than(step, boundaries[0])
        elif i < len(values) - 1:
            indicator = _step_in_range(step, boundaries[i - 1], boundaries[i])
        else:
            indicator = _step_ge(step, boundaries[-1])
        term = indicator * float(v)
        lr = term if lr is None else lr + term
    return lr


def _to_float(cond_var):
    return nn.cast(cond_var, "float32")


def _step_less_than(step, b):
    return _to_float(step < float(b))


def _step_ge(step, b):
    return _to_float(step >= float(b))


def _step_in_range(step, lo, hi):
    return _step_ge(step, lo) * _step_less_than(step, hi)


def noam_decay(d_model, warmup_steps):
    """The Transformer's rate: d_model^-0.5 · min(step^-0.5,
    step · warmup_steps^-1.5)."""
    step = global_step_counter()
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    lr = nn.elementwise_min(a, b)
    return lr * (d_model ** -0.5)


autoincreased_step_counter = global_step_counter
