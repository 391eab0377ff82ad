"""The bfloat16 paged decode kernel's plain version and arithmetic
against the JAX package, on the CPU.

Inputs come from numpy seeds (tests/test_torch_flash_attention.py's
``_paged_inputs``), rounded to bfloat16, and go through the JAX function
and its counterpart in paddle_tpu_torch/kernels/flash_attention.py. The
JAX side runs its reference and its Pallas kernel in interpret mode on
the same bfloat16 inputs: both widen q, K and V to float32, run the
softmax and P.V in float32 and round the output once to bfloat16.

* the plain version (``paged_attention_reference``, which
  ``paged_decode_attention_bf16`` runs on CPU tensors) against the
  Pallas kernel and the JAX reference: within 2^-7 max|jax| + 2^-7 |jax|
  (BF16_REL; bfloat16's unit roundoff is 2^-8, and a sum taken in
  another order may round to the neighbouring value), the share of
  output values whose bits differ printed;
* the split kernel's arithmetic (``_paged_split`` in float32 on the
  widened inputs, then one rounding: csrc/paged_attention.cu's bfloat16
  instance in PyTorch) against the same, at the split edges and with
  ids out of range;
* the wrappers on the CPU count no launch.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_attention import _paged_inputs, _paged_split

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
torch.set_num_threads(2)

BF16_REL = 2.0 ** -7


def _bf16(args):
    """The float arrays of `args` rounded to bfloat16: (numpy bfloat16
    for JAX, torch bfloat16); the int arrays as they are."""
    j, t = [], []
    for a in args:
        if a.dtype == np.float32:
            b = a.astype(ml_dtypes.bfloat16)
            j.append(jnp.asarray(b))
            t.append(torch.from_numpy(b.astype(np.float32))
                     .to(torch.bfloat16))
        else:
            j.append(jnp.asarray(a))
            t.append(torch.from_numpy(a))
    return j, t


def _held(got: torch.Tensor, want, what: str) -> float:
    """Assert `got` (bfloat16) within the bf16 limit of `want`; return
    the share of values whose bits differ."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    lim = BF16_REL * np.abs(w).max() + BF16_REL * np.abs(w)
    share = float((np.abs(g - w) / np.maximum(lim, 1e-30)).max())
    differ = float((g != w).mean())
    print(f"{what}: largest share of the bf16 limit {share:.4f}, values "
          f"whose bits differ {differ:.4f}")
    assert share <= 1.0, share
    return differ


@pytest.mark.parametrize("seed,lens", [(11, [13, 0, 21]),
                                       (12, [1, 8, 9, 40, 0])])
def test_bf16_plain_version_matches_jax_kernel_interpret(seed, lens):
    """d 128, bs 8: the Pallas paged kernel in interpret mode on bfloat16
    inputs, ragged lengths and an idle slot."""
    args = _paged_inputs(seed, len(lens), 2, 128, 16, 8, lens)
    j, t = _bf16(args)
    want = jfa.paged_decode_attention(*j, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tfa.paged_decode_attention_bf16(*t)
    differ = _held(got, want, "plain vs Pallas (interpret)")
    assert differ <= 0.01
    assert torch.equal(tfa.paged_decode_attention(*t), got)
    for i, n in enumerate(lens):
        if n == 0:
            assert bool((got[i] == 0).all())
    ref = jfa.paged_attention_reference(*j)
    _held(got, ref, "plain vs the JAX reference")


@pytest.mark.parametrize("p", [16, tfa.PAGED_SPLIT_KEYS])
@pytest.mark.parametrize("d,bs", [(128, 8), (256, 16)])
def test_bf16_split_arithmetic_matches_jax(p, d, bs):
    """Lengths 0, 1, P - 1, P, P + 1 and the table's whole capacity, an
    id out of range inside a length (read as the null block): the split
    kernel's arithmetic in float32 on the widened inputs, rounded once,
    against the JAX reference on the table with that id set to 0, and
    against the Pallas kernel in interpret mode."""
    cap = -(-(2 * p + 5) // bs) * bs
    lens = [0, 1, p - 1, p, p + 1, cap]
    nb = 2 + sum(-(-n // bs) for n in lens)
    q, kp, vp, tables, lens_a = _paged_inputs(p + d, 6, 2, d, nb, bs, lens)
    tables = tables[:, :cap // bs].copy()
    safe = tables.copy()
    tables[5, 1] = -3
    safe[5, 1] = 0
    j, t = _bf16((q, kp, vp, safe, lens_a))
    got = _paged_split(*(x.float() for x in t[:3]),
                       torch.from_numpy(tables), t[4], p).to(torch.bfloat16)
    assert bool((got[0] == 0).all())
    _held(got, jfa.paged_attention_reference(*j),
          f"split arithmetic P {p} vs the JAX reference")
    _held(got, jfa.paged_decode_attention(*j, interpret=True),
          f"split arithmetic P {p} vs Pallas (interpret)")


def test_bf16_cpu_wrappers_count_no_launches():
    _, t = _bf16(_paged_inputs(2, 2, 2, 128, 6, 4, [5, 0]))
    n16 = tfa.paged_decode_attention_bf16.launches
    n32 = tfa.paged_decode_attention.launches
    tfa.paged_decode_attention(*t)
    tfa.paged_decode_attention_bf16(*t)
    assert tfa.paged_decode_attention_bf16.launches == n16
    assert tfa.paged_decode_attention.launches == n32
