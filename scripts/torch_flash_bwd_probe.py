"""Where the time of the port's flash-attention dQ kernel goes, on one GPU.

Builds the dQ kernel of ``paddle_tpu_torch/csrc/flash_attention_bwd.cu``
(Q·Kᵀ, dO·Vᵀ and dS·K in 3xTF32 on the tensor cores, dS formed on the
fragments, K landing under dO·Vᵀ and the next V under Q·Kᵀ and dS·K) and
ablations of it, made by removing calls from copies of the source and
its headers:

* ``no copies``: the key tiles after the first never copied (Q, dO and
  the first K and V tile still land once a block), the products over
  whatever shared memory holds;
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;

and, with ``--parent DIR``, the dQ kernel of another tree (DIR holds its
``paddle_tpu_torch/csrc``), e.g. the parent unpacked by ``git archive``,
whose dK/dV kernel is also held against this tree's: SASS function by
function, dK and dV bit for bit. At each of chip_smoke.py's FLASH_SHAPES
(H 8, D 256, causal) every build is timed with CUDA events, in turns
(the list, then the list reversed), and the kernel reports its TF32
rate: three TF32 products of 6·D flops per visible (query, key) pair.
The ablations compute nothing useful; the wrapper
(``flash_attention.flash_attention_bwd_dq``) is checked against its
plain version first (within atol = rtol = 1e-4, as phase 3 holds it),
two calls bit-identical, and both the kernel's dQ and the plain
version's (float32, TF32 off) are held against the same in float64:
which of the two carries the difference. Last, one backward through
PyTorch's scaled_dot_product_attention is profiled and its kernels'
names printed, with its time (forward and backward less the forward)
beside the kernel's. Run from the repository root on a machine with the
CUDA toolkit: ``python scripts/torch_flash_bwd_probe.py [--parent DIR]``.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402
import torch_flash_fwd_probe as fp  # noqa: E402

SHAPES, H, D = fp.SHAPES, fp.H, fp.D
SOURCE = "flash_attention_bwd.cu"
TOL = 1e-4
NO_COPY = (("    if (kt + 1 < n_tiles) copy_rows<D, kBK, D, true>(sV,",
            "    if (false) copy_rows<D, kBK, D, true>(sV,"),
           ("    if (kt + 1 < n_tiles) copy_rows<D, kBK, D, true>(sK,",
            "    if (false) copy_rows<D, kBK, D, true>(sK,"))
VARIANTS = {"kernel": (), "no copies": NO_COPY, "no mma": fp.NO_MMA}
DQ_ARGS = (fp.P,) * 7 + (fp.I,) * 5 + (fp.FL, fp.I, fp.P)
DKV_ARGS = (fp.P,) * 8 + (fp.I,) * 5 + (fp.FL, fp.I, fp.P)


def exact_dq(q, k, v, do):
    """dQ of causal attention in float64 (the plain version's arithmetic,
    which computes in float32)."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    pos = torch.arange(q.shape[1], device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, fa.DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    return torch.einsum("bhqk,bkhd->bqhd", p * (dp - delta), k) * D ** -0.5


def sdpa_bwd_kernels(qt, kt, vt, dot) -> str:
    """The names of the device kernels of one backward through SDPA."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    torch.autograd.grad(out, (qt, kt, vt), dot)
    torch.cuda.synchronize()
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, (qt, kt, vt), dot)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    return "; ".join(sorted(names)) or "the profiler saw no device kernel"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a tree whose flash backward kernels to time and "
                         "hold beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out_dir = build.BUILD_DIR / "flash_bwd_probe"
    built = fp.compile_variants(out_dir, args.parent, SOURCE, VARIANTS,
                                "flash_attention_bwd_dq_f32", DQ_ARGS)
    fns = {name: fn for name, (fn, _) in built.items()}
    dkv = None
    if "parent" in built:
        print(fp.same_sass((built["parent"][1], built["kernel"][1]),
                           "flash_bwd_dkv_kernel"),
              "(this tree against the parent's)")
        dkv = {}
        for name in ("kernel", "parent"):
            f = ctypes.CDLL(str(built[name][1])).flash_attention_bwd_dkv_f32
            f.argtypes = list(DKV_ARGS)
            f.restype = ctypes.c_int
            dkv[name] = f
    gen = torch.Generator(device="cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s in SHAPES:
        q, k, v, do = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        delta = fa.flash_attention_bwd_delta(o, do)
        bwd = (q, k, v, do, lse, delta)
        dq = fa.flash_attention_bwd_dq(*bwd, causal=True)
        dq2 = fa.flash_attention_bwd_dq(*bwd, causal=True)
        rq = fa.flash_attention_bwd_dq_reference(*bwd, causal=True)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(dq, dq2))

        def share(got, want):
            return float(((got.double() - want).abs()
                          / (TOL + TOL * want.abs())).max())
        limit = share(dq, rq.double())
        assert limit <= 1 and repeat, (limit, repeat)
        eq = exact_dq(q, k, v, do)
        f64 = {"kernel": share(dq, eq), "plain": share(rq, eq)}
        del eq, rq, dq2, o
        out = torch.empty_like(q)
        ptrs = [x.data_ptr() for x in (*bwd, out)]
        note = ""
        if dkv is not None:
            dk, dv = (torch.empty_like(k) for _ in range(2))
            got = {}
            for name in ("kernel", "parent"):
                err = dkv[name](*ptrs[:6], dk.data_ptr(), dv.data_ptr(), b, H,
                                s, s, D, D ** -0.5, 1, stream)
                assert err == 0, (name, err)
                torch.cuda.synchronize()
                got[name] = (dk.clone(), dv.clone())
            same = all(torch.equal(x, y) for x, y in zip(got["kernel"],
                                                          got["parent"]))
            note = f"; dK/dV bit-identical to the parent's {same}"
            del got, dk, dv
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                def call(f=fns[name], name=name):
                    err = f(*ptrs, b, H, s, s, D, D ** -0.5, 1, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times[name].append(c3.cuda_ms(call))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        fwd = c3.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        both = c3.cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            (qt, kt, vt), dot))
        pairs = b * H * s * (s + 1) // 2
        tf32 = 3 * 6 * D * pairs
        print(f"flash_attention_bwd_dq B {b}, S {s}, H {H}, D {D}, causal: "
              + "; ".join(f"{name} {m:.4f} ms ("
                          + ", ".join(f"{t:.4f}" for t in times[name]) + ")"
                          for name, m in ms.items())
              + f"; sdpa backward {both - fwd:.4f} ms (fwd+bwd {both:.4f}, "
              f"fwd {fwd:.4f}); kernel {tf32 / ms['kernel'] / 1e9:.1f} "
              f"TFLOP/s of TF32 ({tf32 / 1e9:.2f} GFLOP, bound "
              f"{1e3 * tf32 / fp.TF32_FLOPS_PER_S:.4f} ms); largest share of "
              f"the 1e-4 limit {limit:.4f}; two calls bit-identical {repeat}"
              f"{note}; against float64: kernel {f64['kernel']:.4f}, plain "
              f"{f64['plain']:.4f} [{card}]", flush=True)
        if (b, s) == SHAPES[-1]:
            print(f"sdpa backward kernels at B {b}, S {s}: "
                  f"{sdpa_bwd_kernels(qt, kt, vt, dot)}")
        del q, k, v, do, lse, delta, dq, out, qt, kt, vt, dot
    return 0


if __name__ == "__main__":
    sys.exit(main())
