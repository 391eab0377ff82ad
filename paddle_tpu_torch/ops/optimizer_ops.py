"""Optimizer update ops, registered by the JAX package's names.

Counterparts of ``sgd``, ``momentum`` and ``adam`` in
``paddle_tpu/ops/optimizer_ops.py`` (dense gradients; a row-sparse
gradient is not ported and raises). Moments stored in bfloat16
(``PT_OPT_STATE_DTYPE``) are widened to float32 for the update and
stored back in their own dtype.
Each returns the updated tensors and the lowering rebinds the
persistable names, as in the JAX package; the lowering runs them under
``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _p(ins, slot):
    return ins[slot][0]


@register_op("sgd")
def sgd(ctx, ins, attrs):
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    return {"ParamOut": [p - lr * g]}


@register_op("momentum")
def momentum(ctx, ins, attrs):
    """v' = mu·v + g; p' = p − lr·v', or p − (g + mu·v')·lr with
    use_nesterov."""
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    v = _p(ins, "Velocity")
    if g.layout != torch.strided:
        raise NotImplementedError("momentum with a row-sparse gradient is "
                                  "not ported")
    mu = attrs["mu"]
    v_new = mu * v.float() + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new.to(v.dtype)]}


@register_op("adam")
def adam(ctx, ins, attrs):
    """m/v moments and the scalar beta-power accumulators (bias
    correction from the pre-update powers)."""
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p, b2p = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m.float() + (1 - b1) * g
    v_new = b2 * v.float() + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": [p_new], "Moment1Out": [m_new.to(m.dtype)],
            "Moment2Out": [v_new.to(v.dtype)], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}
