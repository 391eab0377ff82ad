"""IO layers: the `data` feed declaration.

Counterpart of ``paddle_tpu/layers/io.py`` ``data``. Ragged (lod_level
>= 1) sequence feeds are not ported.
"""

from __future__ import annotations

from ..core.program import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    if lod_level >= 1:
        raise NotImplementedError(
            f"layers.data({name!r}, lod_level={lod_level}): ragged sequence "
            "feeds are not ported")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block
    var = block.create_var(name, shape=shape, dtype=dtype, lod_level=lod_level)
    var.stop_gradient = stop_gradient
    var.is_data = True
    return var
