"""pool2d with ceil_mode against the JAX package on the CPU.

The JAX package's pool2d op declares the ceil-mode output shape
(its shape inference rounds up) but computes with symmetric padding
and a floored size. The port is held to the reference: its op
computes what the JAX op computes, and its shape inference declares
what the JAX package declares, so the two programs stay equal op for
op. Shapes where ceil and floor differ (7x7 with a 2x2 window, stride
2). Tolerance: float32 sums of at most 9 elements, atol = rtol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import program as jprog
from paddle_tpu.ops import nn_ops as jnn

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.core.registry import get_op

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ptype,exclusive", [("max", True), ("avg", True),
                                             ("avg", False)])
@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (2, 3, 1)])
def test_pool2d_ceil_mode_matches_jax(ptype, exclusive, k, s, p):
    x = np.random.default_rng(k + s + p).standard_normal(
        (2, 3, 7, 7)).astype(np.float32)
    attrs = {"pooling_type": ptype, "ksize": [k, k], "strides": [s, s],
             "paddings": [p, p], "ceil_mode": True, "exclusive": exclusive}
    want = np.asarray(jnn.pool2d(None, {"X": [jnp.asarray(x)]},
                                 attrs)["Out"][0])
    got = get_op("pool2d").compute(None, {"X": [torch.from_numpy(x)]},
                                   attrs)["Out"][0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("ceil_mode", [False, True])
def test_pool2d_programs_declare_the_same_shapes(ceil_mode):
    dicts = []
    for pkg, prog_mod in ((jpt, jprog), (pt, tprog)):
        prog_mod.reset_unique_names()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data("x", [3, 7, 7])
            out = pkg.layers.pool2d(x, pool_size=2, pool_stride=2,
                                    ceil_mode=ceil_mode)
        dicts.append(main.to_dict())
        assert out.shape == (-1, 3) + ((4, 4) if ceil_mode else (3, 3))
    assert dicts[0] == dicts[1]
