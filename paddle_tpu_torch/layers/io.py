"""IO layers: the `data` feed declaration.

Counterpart of ``paddle_tpu/layers/io.py`` ``data``. A ragged (lod_level
>= 1) var gets a time dim after the batch dim and a ``name@SEQ_LEN``
companion var that holds the lengths (the Executor fills it from a list
or LoDTensor feed, or with full lengths).
"""

from __future__ import annotations

from ..core.program import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level >= 1:
        # padded ragged representation: insert the time dim and declare
        # the @SEQ_LEN companion
        shape = shape[:1] + [-1] + shape[1:]
    block = default_main_program().global_block
    var = block.create_var(name, shape=shape, dtype=dtype, lod_level=lod_level)
    var.stop_gradient = stop_gradient
    var.is_data = True
    if lod_level >= 1:
        seq_len = block.create_var(name + "@SEQ_LEN", shape=(-1,),
                                   dtype="int32", lod_level=0)
        seq_len.stop_gradient = True
        seq_len.is_data = True
        var.seq_len_var = seq_len.name
    return var
