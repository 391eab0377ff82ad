"""Gradient clipping as program ops.

Counterpart of ``paddle_tpu/clip.py``: ``ErrorClipByValue`` (and the
``error_clip_callback`` hook ``append_backward`` takes),
``GradientClipByValue``, ``GradientClipByNorm``,
``GradientClipByGlobalNorm`` and ``set_gradient_clip``. The clip ops
rewrite the ``@GRAD`` vars in place, between the backward boundary and
the regularization and update ops; a global-norm clip builds its scale,
clip_norm / max(‖all its grads‖₂, clip_norm), once.
"""

from __future__ import annotations

from typing import List, Tuple

from .core.program import VarDesc, default_main_program
from .layer_helper import LayerHelper

__all__ = ["BaseErrorClipAttr", "ErrorClipByValue", "error_clip_callback",
           "BaseGradientClipAttr", "NullGradientClipAttr",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def append_clip_op(self, block, grad_name):
        block.append_op("clip", {"X": grad_name}, {"Out": grad_name},
                        {"min": self.min, "max": self.max})


def error_clip_callback(block=None, context=None):
    """The hook ``append_backward`` is given, kept for the API: autograd
    has no per-op gradient stream to intercept, so an error clip acts on
    the final gradients, as in the JAX package."""
    return None


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        raise NotImplementedError

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_grad")
        helper.append_op("clip", {"X": grad}, {"Out": grad},
                         {"min": self.min, "max": self.max})
        return param, grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_grad_by_norm")
        helper.append_op("clip_by_norm", {"X": grad}, {"Out": grad},
                         {"max_norm": self.clip_norm})
        return param, grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """scale = clip_norm / max(global_norm, clip_norm), one global norm
    over every gradient this clip is attached to."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
        self.context_name = "global_norm_ctx"

    def _process_context(self, context, param, grad):
        context.setdefault(self.context_name, []).append(grad)

    def _create_operators(self, param, grad):
        helper = LayerHelper("clip_grad_global")
        helper.append_op("elementwise_mul", {"X": grad, "Y": self._scale_var},
                         {"Out": grad})
        return param, grad

    def _build_scale(self, grads):
        from .layers import tensor
        helper = LayerHelper("global_norm")
        sq_sums = []
        for g in grads:
            sq = helper.create_tmp_variable(g.dtype)
            sq.stop_gradient = True
            helper.append_op("squared_l2_norm", {"X": g}, {"Out": sq})
            sq_sums.append(sq)
        total = helper.create_tmp_variable("float32")
        total.stop_gradient = True
        helper.append_op("sum", {"X": sq_sums}, {"Out": total})
        norm = helper.create_tmp_variable("float32")
        norm.stop_gradient = True
        helper.append_op("sqrt", {"X": total}, {"Out": norm})
        max_norm = tensor.fill_constant([1], "float32", self.clip_norm)
        denom = helper.create_tmp_variable("float32")
        denom.stop_gradient = True
        helper.append_op("elementwise_max", {"X": norm, "Y": max_norm},
                         {"Out": denom})
        scale = helper.create_tmp_variable("float32")
        scale.stop_gradient = True
        helper.append_op("elementwise_div", {"X": max_norm, "Y": denom},
                         {"Out": scale})
        self._scale_var = scale


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach `clip` to the parameters (every parameter of `program` by
    default)."""
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block.all_parameters()
    param_list = [program.global_block.var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads: List[Tuple[VarDesc, VarDesc]]):
    context = {}
    clips = []
    for p, g in param_grads:
        clip_attr = (getattr(p, "gradient_clip_attr", None)
                     or NullGradientClipAttr())
        clips.append(clip_attr)
        clip_attr._process_context(context, p, g)
    # a global-norm clip builds its scale once, from all its grads
    built = set()
    for clip_attr in clips:
        if (isinstance(clip_attr, GradientClipByGlobalNorm)
                and id(clip_attr) not in built):
            clip_attr._build_scale(context[clip_attr.context_name])
            built.add(id(clip_attr))
    res = []
    for (p, g), clip_attr in zip(param_grads, clips):
        if g is None:
            res.append((p, g))
            continue
        res.append(clip_attr._create_operators(p, g))
    return res
