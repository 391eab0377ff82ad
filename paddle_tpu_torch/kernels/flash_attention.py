"""Flash attention (forward and backward) and paged decode attention: CUDA
kernels and their plain PyTorch versions.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. Layouts are the
JAX package's: q, k, v are [batch, seq, heads, head_dim] ("BSHD"); the
paged pools are [num_blocks, block_size, heads, head_dim] with block 0
reserved as the null block.

Four kernels, each written by hand for Hopper in ``paddle_tpu_torch/csrc``
(the note at the top of each source says what bounds it and what its
design does about that):

* ``flash_attention_fwd`` (csrc/flash_attention.cu) replaces the Pallas
  forward ``_flash_fwd``;
* ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``
  (csrc/flash_attention_bwd.cu) replace the two Pallas backward kernels
  of ``_flash_bwd_pallas``; ``flash_attention_bwd`` runs both;
* ``paged_decode_attention`` (csrc/paged_attention.cu) replaces the Pallas
  ``_paged_attention_pallas``.

``FlashAttention`` is the ``torch.autograd.Function`` of the pair (the
JAX package's ``custom_vjp``), and ``dot_product_attention`` dispatches
to it on a CUDA tensor, so training runs all three flash kernels.

Each wrapper runs its plain version (``flash_attention_fwd_reference``,
``flash_attention_bwd_dq_reference``, ``flash_attention_bwd_dkv_reference``,
``paged_attention_reference``) only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises; there is no fallback. Each keeps
a plain integer ``launches`` count, raised by one per kernel launch.

``paged_kv_update`` is the one piece of the decode write that was an XLA
scatter, not Pallas: here it writes the pools IN PLACE.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build

__all__ = ["DEFAULT_MASK_VALUE", "mha_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_delta",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_reference", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd",
           "FlashAttention", "dot_product_attention",
           "paged_attention_reference", "paged_decode_attention",
           "paged_kv_update"]

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _masked_scores(q, k, bias, causal: bool, scale: float) -> torch.Tensor:
    """[B, H, Sq, Sk] f32 scores, causal entries above the bottom-right
    aligned diagonal set to DEFAULT_MASK_VALUE."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, DEFAULT_MASK_VALUE)
    return s


def mha_reference(q, k, v, bias=None, *, causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q,k,v: [B, S, H, D] (k/v may have S_kv != S_q)."""
    s = _masked_scores(q, k, bias, causal, _default_scale(q, scale))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def flash_attention_fwd_reference(q, k, v, *, causal: bool = False,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash kernel returns: (O [B, Sq, H, D], logsumexp of each
    score row [B*H, Sq] f32)."""
    s = _masked_scores(q, k, None, causal, _default_scale(q, scale))
    o = torch.einsum("bhqk,bkhd->bqhd",
                     torch.softmax(s, dim=-1).to(v.dtype), v)
    b, h, sq = s.shape[:3]
    return o, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


def flash_attention_bwd_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) of each query row: [B*H, Sq] float32, the
    backward kernels' layout of lse."""
    b, sq, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(
        b * h, sq).contiguous()


def _bwd_chunks(q, k, v, do, lse, delta, causal: bool, scale: float,
                block_q: int = 128):
    """The chunked scan of the JAX package's ``_flash_bwd_rule``: for each
    block of query rows [i0, i1), p = exp(s - lse) and
    ds = p * (dp - delta) over all keys, [B, H, rows, Sk] float32."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    kf, vf = k.float(), v.float()
    lse4 = lse.reshape(b, h, sq, 1)
    delta4 = delta.reshape(b, h, sq, 1)
    ki = torch.arange(sk, device=q.device)[None, :]
    for i0 in range(0, sq, block_q):
        i1 = min(sq, i0 + block_q)
        qc, doc = q[:, i0:i1].float(), do[:, i0:i1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)[:, None] + (sk - sq)
            s = torch.where(ki <= qpos, s, DEFAULT_MASK_VALUE)
        p = torch.exp(s - lse4[:, :, i0:i1])
        dp = torch.einsum("bqhd,bkhd->bhqk", doc, vf)
        yield qc, doc, p, p * (dp - delta4[:, :, i0:i1])


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, *,
                                     causal: bool = False,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """What the dQ kernel returns: dQ = dS K * scale, [B, Sq, H, D]."""
    scale = _default_scale(q, scale)
    kf = k.float()
    return torch.cat([torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
                      for _, _, _, ds in _bwd_chunks(q, k, v, do, lse, delta,
                                                     causal, scale)],
                     dim=1).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, *,
                                      causal: bool = False,
                                      scale: Optional[float] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the dK/dV kernel returns: dK = dS^T Q * scale, dV = P^T dO,
    each [B, Sk, H, D], summed over the query blocks."""
    scale = _default_scale(q, scale)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for qc, doc, p, ds in _bwd_chunks(q, k, v, do, lse, delta, causal, scale):
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, doc)
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain backward of the flash forward: (dQ, dK, dV) from the saved
    O and lse [B*H, Sq]."""
    delta = flash_attention_bwd_delta(o, do)
    kw = dict(causal=causal, scale=scale)
    return (flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))


def paged_attention_reference(q, k_pool, v_pool, block_tables, context_lens,
                              *, scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Gather-based paged attention: every table entry's page is copied
    out of the pool, then masked softmax (the CPU path and the oracle)."""
    s_n, h, d = q.shape
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    scale = _default_scale(q, scale)
    flat = block_tables.reshape(-1).long()
    k = k_pool.index_select(0, flat).reshape(s_n, mb * bs, h, d)
    v = v_pool.index_select(0, flat).reshape(s_n, mb * bs, h, d)
    s = torch.einsum("shd,skhd->shk", q.float(), k.float()) * scale
    kpos = torch.arange(mb * bs, device=q.device)[None, None, :]
    mask = kpos < context_lens.long()[:, None, None]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    # all-masked rows (context_len 0: the null slot) divide by 1 -> zeros;
    # any live row has l >= exp(0) = 1 at its own max
    p = p / torch.clamp(l, min=1.0)
    out = torch.einsum("shk,skhd->shd", p, v.float())
    return out.to(q.dtype)


def paged_kv_update(k_pool, v_pool, k_new, v_new, block_tables,
                    context_lens):
    """Write one new K/V row per sequence into its page, IN PLACE:
    position context_len-1, block block_tables[s, pos // bs], offset
    pos % bs. Inactive slots (context_len 0) write harmlessly into null
    block 0. Returns the (same, updated) pools.

    The JAX version returns new arrays; the port mutates the pools so a
    decode step never copies them."""
    bs = k_pool.shape[1]
    lens = context_lens.long()
    pos = torch.clamp(lens - 1, min=0)
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    blk = torch.where(lens > 0, blk, 0)
    off = pos % bs
    k_pool.index_put_((blk, off), k_new.to(k_pool.dtype))
    v_pool.index_put_((blk, off), v_new.to(v_pool.dtype))
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _flash_fn():
    fn = build.library("flash_attention.cu").flash_attention_fwd_f32
    fn.argtypes = [_P] * 5 + [_I] * 5 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_dq_fn():
    fn = build.library("flash_attention_bwd.cu").flash_attention_bwd_dq_f32
    fn.argtypes = [_P] * 7 + [_I] * 5 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_dkv_fn():
    fn = build.library("flash_attention_bwd.cu").flash_attention_bwd_dkv_f32
    fn.argtypes = [_P] * 8 + [_I] * 5 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _paged_fn():
    fn = build.library("paged_attention.cu").paged_decode_attention_f32
    fn.argtypes = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check_cuda(name: str, t: torch.Tensor, device: torch.device,
                dtype: torch.dtype, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    _require(t.dim() == ndim, f"{name} must have {ndim} dims, got "
                              f"{tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    if dtype == torch.float32:
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (O [B, Sq, H, D], lse [B*H, Sq] f32).

    CPU tensors run ``flash_attention_fwd_reference``. CUDA tensors run
    csrc/flash_attention.cu, which takes float32 contiguous BSHD tensors
    with head_dim 64, 128 or 256, any sequence lengths, and causal only
    with sq <= sk (the JAX dispatch routes causal sq > sk to the reference,
    whose semantics the kernel's zero-sum guard does not share)."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.device, torch.float32, 4)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[2:] == (h, d),
             f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
             f"q {tuple(q.shape)}")
    _require(d in (64, 128, 256), f"head_dim {d} not in (64, 128, 256)")
    _require(sq > 0 and sk > 0 and b * h > 0, "empty attention")
    if causal and sq > sk:
        raise ValueError(f"causal attention with sq={sq} > sk={sk} has no "
                         "kernel; use mha_reference")
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_attention_fwd", _flash_fn(), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b,
                h, sq, sk, d, scale, int(bool(causal)), stream)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _check_bwd(q, k, v, do, lse, delta, causal: bool):
    """The backward kernels' contract: the forward kernel's inputs, dO
    like q, lse and delta [B*H, Sq] float32."""
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_cuda(name, t, q.device, torch.float32, 4)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_cuda(name, t, q.device, torch.float32, 2)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[2:] == (h, d),
             f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
             f"q {tuple(q.shape)}")
    _require(do.shape == q.shape, f"do {tuple(do.shape)} is not shaped as q "
                                  f"{tuple(q.shape)}")
    _require(lse.shape == (b * h, sq) and delta.shape == (b * h, sq),
             f"lse {tuple(lse.shape)} and delta {tuple(delta.shape)} must be "
             f"[B*H, Sq] = {(b * h, sq)}")
    _require(d in (64, 128, 256), f"head_dim {d} not in (64, 128, 256)")
    _require(sq > 0 and sk > 0 and b * h > 0, "empty attention")
    if causal and sq > sk:
        raise ValueError(f"causal attention with sq={sq} > sk={sk} has no "
                         "kernel; use mha_reference")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dQ of flash attention from the forward's lse and delta (see
    ``flash_attention_bwd_delta``). CPU tensors run
    ``flash_attention_bwd_dq_reference``; CUDA tensors run the dQ kernel
    of csrc/flash_attention_bwd.cu under the forward kernel's contract."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dq: no kernel for {q.device}")
    _check_bwd(q, k, v, do, lse, delta, causal)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_attention_bwd_dq", _bwd_dq_fn(), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[1], d,
                scale, int(bool(causal)), stream)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *,
                            causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention. CPU tensors run
    ``flash_attention_bwd_dkv_reference``; CUDA tensors run the dK/dV
    kernel of csrc/flash_attention_bwd.cu."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dkv: no kernel for {q.device}")
    _check_bwd(q, k, v, do, lse, delta, causal)
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_attention_bwd_dkv", _bwd_dkv_fn(), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq,
                k.shape[1], d, scale, int(bool(causal)), stream)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        scale: Optional[float] = None):
    """(dQ, dK, dV) of the flash forward from its saved O and lse: delta
    as one PyTorch expression (as the JAX package computes it outside
    Pallas), then the dQ kernel and the dK/dV kernel."""
    delta = flash_attention_bwd_delta(o, do)
    kw = dict(causal=causal, scale=scale)
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel saves O and
    lse, the backward kernels recompute the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        scale = _default_scale(q, scale)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           *, scale: Optional[float] = None) -> torch.Tensor:
    """One query token per slot against its pages: q [S, H, D] -> [S, H, D].

    CPU tensors run ``paged_attention_reference``. CUDA tensors run
    csrc/paged_attention.cu, which reads each page in place through the
    block table; it takes float32 contiguous q and pools with head_dim 128
    or 256 (the TPU kernel's head_dim % 128 == 0) and int32 tables and
    lengths."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    _check_cuda("q", q, q.device, torch.float32, 3)
    _check_cuda("k_pool", k_pool, q.device, torch.float32, 4)
    _check_cuda("v_pool", v_pool, q.device, torch.float32, 4)
    _check_cuda("block_tables", block_tables, q.device, torch.int32, 2)
    _check_cuda("context_lens", context_lens, q.device, torch.int32, 1)
    s_n, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    _require(k_pool.shape == v_pool.shape and k_pool.shape[2:] == (h, d),
             f"pools {tuple(k_pool.shape)}, {tuple(v_pool.shape)} do not "
             f"match q {tuple(q.shape)}")
    _require(d in (128, 256), f"head_dim {d} not in (128, 256)")
    _require(block_tables.shape[0] == s_n and context_lens.shape[0] == s_n,
             "block_tables/context_lens must have one row per slot")
    out = torch.empty_like(q)
    if s_n == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("paged_decode_attention", _paged_fn(), q.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(), s_n, h, d, nb, bs,
                block_tables.shape[1], scale, stream)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def dot_product_attention(q, k, v, bias=None, *, causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Public entry: ``FlashAttention`` (the forward kernel, and the two
    backward kernels under autograd) on CUDA, ``mha_reference`` on CPU.

    A bias (additive mask) has no kernel: the kernel handles the causal
    structure itself and arbitrary bias tiles would defeat the block skip.
    On CUDA it raises instead of leaving the device path."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, bias, causal=causal, scale=scale)
    if bias is not None:
        raise ValueError("dot_product_attention: a bias has no CUDA kernel "
                         "(not ported)")
    return FlashAttention.apply(q, k, v, causal, scale)
