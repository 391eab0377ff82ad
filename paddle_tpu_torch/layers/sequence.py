"""Sequence layers over padded + lengths ragged batches.

Counterpart of the layers of ``paddle_tpu/layers/sequence.py`` that the
stacked LSTM builds: ``sequence_pool`` (with ``sequence_first_step`` and
``sequence_last_step``) and the fused recurrent layers ``dynamic_lstm``,
``dynamic_lstmp`` and ``dynamic_gru``. Every sequence var carries an
``@SEQ_LEN`` companion (``VarDesc.seq_len_var``), wired automatically;
``propagate_seq`` carries it through a timestep-preserving layer. The
other sequence layers are not ported.
"""

from __future__ import annotations

import copy

from ..core.program import VarDesc
from ..layer_helper import LayerHelper

__all__ = ["propagate_seq", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "dynamic_lstm", "dynamic_lstmp",
           "dynamic_gru"]


def _seq_len_of(x: VarDesc) -> str:
    name = getattr(x, "seq_len_var", None)
    if not name:
        raise ValueError(
            f"{x.name} is not a sequence variable (no @SEQ_LEN companion); "
            "declare it with layers.data(..., lod_level=1)")
    return name


def _mark_seq(out: VarDesc, seq_len_name: str) -> VarDesc:
    out.seq_len_var = seq_len_name
    out.lod_level = 1
    return out


def propagate_seq(src: VarDesc, dst: VarDesc) -> VarDesc:
    """Carry the sequence companion through a timestep-preserving layer."""
    if getattr(src, "seq_len_var", None):
        dst.seq_len_var = src.seq_len_var
        dst.lod_level = src.lod_level
    return dst


def sequence_pool(input, pool_type: str):
    helper = LayerHelper("sequence_pool")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("sequence_pool",
                     {"X": input, "SeqLen": _seq_len_of(input)},
                     {"Out": out}, {"pooltype": pool_type})
    if input.shape:
        out.shape = tuple(input.shape[:1]) + tuple(input.shape[2:])
        out.dtype = input.dtype
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """`size` = 4 x hidden (the reference's convention); input is the
    pre-projected [B, T, 4H]. Returns (hidden, cell), each [B, T, H]."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    hidden_size = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     [hidden_size, 4 * hidden_size], dtype)
    bias_size = 4 * hidden_size + (3 * hidden_size if use_peepholes else 0)
    bias = helper.create_parameter(helper.bias_attr, [1, bias_size], dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    inputs = {"Input": input, "Weight": weight, "Bias": bias,
              "SeqLen": _seq_len_of(input)}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("dynamic_lstm", inputs,
                     {"Hidden": hidden, "Cell": cell},
                     {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation})
    shape = tuple(input.shape[:2]) + (hidden_size,)
    hidden.shape = cell.shape = shape
    hidden.dtype = cell.dtype = dtype
    _mark_seq(hidden, input.seq_len_var)
    _mark_seq(cell, input.seq_len_var)
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """LSTM with a recurrent projection (lstmp_op.cc). `size` = 4 x
    hidden; returns (projection [B, T, P], cell [B, T, H])."""
    helper = LayerHelper("lstmp", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    hidden_size = size // 4
    # separate ParamAttr copies: create_parameter binds attr.name in place,
    # so sharing one attr would collide the two weights
    weight = helper.create_parameter(copy.copy(helper.param_attr),
                                     [proj_size, 4 * hidden_size], dtype)
    proj_attr = copy.copy(helper.param_attr)
    if getattr(proj_attr, "name", None):
        # an explicit ParamAttr(name=...) would bind both weights to one
        # parameter; the projection weight gets its own name
        proj_attr.name = proj_attr.name + "_proj"
    proj_weight = helper.create_parameter(proj_attr,
                                          [hidden_size, proj_size], dtype)
    bias_size = 4 * hidden_size + (3 * hidden_size if use_peepholes else 0)
    bias = helper.create_parameter(helper.bias_attr, [1, bias_size], dtype,
                                   is_bias=True)
    proj = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    inputs = {"Input": input, "Weight": weight, "ProjWeight": proj_weight,
              "Bias": bias, "SeqLen": _seq_len_of(input)}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("lstmp", inputs,
                     {"Projection": proj, "Cell": cell},
                     {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation,
                      "proj_activation": proj_activation})
    proj.shape = tuple(input.shape[:2]) + (proj_size,)
    cell.shape = tuple(input.shape[:2]) + (hidden_size,)
    proj.dtype = cell.dtype = dtype
    _mark_seq(proj, input.seq_len_var)
    _mark_seq(cell, input.seq_len_var)
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """`size` = hidden; input [B, T, 3H]."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(helper.param_attr, [size, 3 * size],
                                     dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, 3 * size], dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    inputs = {"Input": input, "Weight": weight, "Bias": bias,
              "SeqLen": _seq_len_of(input)}
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op("dynamic_gru", inputs, {"Hidden": hidden},
                     {"is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "activation": candidate_activation})
    hidden.shape = tuple(input.shape[:2]) + (size,)
    hidden.dtype = dtype
    return _mark_seq(hidden, input.seq_len_var)
