"""Where the time of the port's flash-attention backward kernels goes, on
one GPU.

Builds ``paddle_tpu_torch/csrc/flash_attention_bwd.cu`` (dQ: Q·Kᵀ, dO·Vᵀ
and dS·K; dK/dV: K·Qᵀ, V·dOᵀ, Pᵀ·dO and dSᵀ·Q; each in 3xTF32 on the
tensor cores with p and dS formed on the fragments) and ablations of it,
made by removing calls from copies of the source and its headers:

* ``no copies``: dQ's key tiles after the first and dK/dV's query tiles
  after the first never copied (what is resident, and the first tile of
  the other operands, still lands once a block), the products over
  whatever shared memory holds;
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;

and, with ``--parent DIR``, the kernels of another tree (DIR holds its
``paddle_tpu_torch/csrc``), e.g. the parent unpacked by ``git archive``:
its dQ kernel's SASS against this tree's, function by function, and its
dQ bit for bit; its dK/dV kernel timed in turns. The register report of
ptxas and the count of HMMA and FFMA instructions of each dK/dV
instance are printed. At each of chip_smoke.py's FLASH_SHAPES (H 8, D
256, causal) every build of each kernel is timed with CUDA events, in
turns (the list, then the list reversed), and each kernel reports its
TF32 rate: three TF32 products of 6·D (dQ) or 8·D (dK/dV) flops per
visible (query, key) pair. The ablations compute nothing useful; the
wrappers (``flash_attention.flash_attention_bwd_dq``, ``_bwd_dkv``) are
checked against their plain versions first (within atol = rtol = 1e-4,
as phase 3 holds them), two calls bit-identical, and the kernels'
outputs and the plain versions' (float32, TF32 off) are held against the
same in float64: which of the two carries the difference. Last, one
backward through PyTorch's scaled_dot_product_attention is profiled and
its kernels' names printed, with its time (forward and backward less
the forward) beside the kernels'. Run from the repository root on a
machine with the CUDA toolkit:
``python scripts/torch_flash_bwd_probe.py [--parent DIR]``.
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
import torch_chain_ab as ab  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402
import torch_flash_fwd_probe as fp  # noqa: E402

SHAPES, H, D = fp.SHAPES, fp.H, fp.D
SOURCE = "flash_attention_bwd.cu"
TOL = 1e-4
NO_COPY = (("    if (kt + 1 < n_tiles) copy_rows<D, kBK, D, true>(sV,",
            "    if (false) copy_rows<D, kBK, D, true>(sV,"),
           ("    if (kt + 1 < n_tiles) copy_rows<D, kBK, D, true>(sK,",
            "    if (false) copy_rows<D, kBK, D, true>(sK,"),
           ("    if (qt + 1 < n_q) {\n      copy_query_rows<D>(sO,",
            "    if (false) {\n      copy_query_rows<D>(sO,"),
           ("    if (qt + 1 < n_q) copy_query_rows<D>(sQ,",
            "    if (false) copy_query_rows<D>(sQ,"))
VARIANTS = {"kernel": (), "no copies": NO_COPY, "no mma": fp.NO_MMA}
DQ_ARGS = (fp.P,) * 7 + (fp.I,) * 5 + (fp.FL, fp.I, fp.P)
DKV_ARGS = (fp.P,) * 8 + (fp.I,) * 5 + (fp.FL, fp.I, fp.P)


def exact_grads(q, k, v, do):
    """dQ, dK and dV of causal attention in float64 (the plain versions'
    arithmetic, which computes in float32)."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    pos = torch.arange(q.shape[1], device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, fa.DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) * D ** -0.5
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do))


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


def instructions(lib: Path, kernel: str) -> str:
    """HMMA and FFMA counts of each function whose name holds `kernel`."""
    funcs = ab.sass(lib)
    return "; ".join(
        f"{name}: {text.count('HMMA')} HMMA, {text.count('FFMA')} FFMA"
        for name, text in sorted(funcs.items()) if kernel in name)


def share(got, want):
    return float(((got.double() - want).abs()
                  / (TOL + TOL * want.abs())).max())


def timed(fns, call):
    """{name: [ms, ms]} of `call(fn)` for each build, in turns."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(c3.cuda_ms(lambda f=fns[name]: call(f)))
    return times


def report(times) -> str:
    return "; ".join(f"{name} {sum(t) / len(t):.4f} ms ("
                     + ", ".join(f"{x:.4f}" for x in t) + ")"
                     for name, t in times.items())


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
    dq_fns = {name: fn for name, (fn, _) in built.items()}
    dkv_fns = {}
    for name, (_, lib) in built.items():
        f = ctypes.CDLL(str(lib)).flash_attention_bwd_dkv_f32
        f.argtypes = list(DKV_ARGS)
        f.restype = ctypes.c_int
        dkv_fns[name] = f
    print("dK/dV instructions:", instructions(built["kernel"][1],
                                              "flash_bwd_dkv_kernel"))
    if "parent" in built:
        print(fp.same_sass((built["parent"][1], built["kernel"][1]),
                           "flash_bwd_dq_kernel"),
              "(this tree against the parent's)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s in SHAPES:
        q, k, v, do = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        delta = fa.flash_attention_bwd_delta(o, do)
        bwd = (q, k, v, do, lse, delta)
        dq = fa.flash_attention_bwd_dq(*bwd, causal=True)
        dk, dv = fa.flash_attention_bwd_dkv(*bwd, causal=True)
        again = (fa.flash_attention_bwd_dq(*bwd, causal=True),
                 *fa.flash_attention_bwd_dkv(*bwd, causal=True))
        want = (fa.flash_attention_bwd_dq_reference(*bwd, causal=True),
                *fa.flash_attention_bwd_dkv_reference(*bwd, causal=True))
        torch.cuda.synchronize()
        got = (dq, dk, dv)
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        limit = [share(x, w.double()) for x, w in zip(got, want)]
        assert max(limit) <= 1 and repeat, (limit, repeat)
        exact = exact_grads(q, k, v, do)
        f64 = {"kernel": [share(x, e) for x, e in zip(got, exact)],
               "plain": [share(x, e) for x, e in zip(want, exact)]}
        del exact, want, again, o
        out = torch.empty_like(q)
        dk_out, dv_out = torch.empty_like(k), torch.empty_like(v)
        ins = [x.data_ptr() for x in bwd]
        tail = (b, H, s, s, D, D ** -0.5, 1, stream)
        note = ""
        if "parent" in built:
            mine = {}
            for name in ("kernel", "parent"):
                err = dq_fns[name](*ins, out.data_ptr(), *tail)
                assert err == 0, (name, err)
                torch.cuda.synchronize()
                mine[name] = out.clone()
            note = (f"; dQ bit-identical to the parent's "
                    f"{torch.equal(mine['kernel'], mine['parent'])}")
            del mine

        def dq_call(f):
            err = f(*ins, out.data_ptr(), *tail)
            if err:
                raise RuntimeError(f"dQ: CUDA error {err}")

        def dkv_call(f):
            err = f(*ins, dk_out.data_ptr(), dv_out.data_ptr(), *tail)
            if err:
                raise RuntimeError(f"dK/dV: CUDA error {err}")
        times = {"dq": timed(dq_fns, dq_call), "dkv": timed(dkv_fns, dkv_call)}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        fwd = c3.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        both = c3.cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            (qt, kt, vt), dot))
        pairs = b * H * s * (s + 1) // 2
        rates = []
        for part, per_pair in (("dq", 6), ("dkv", 8)):
            tf32 = 3 * per_pair * D * pairs
            ms = sum(times[part]["kernel"]) / 2
            rates.append(f"{part} {tf32 / ms / 1e9:.1f} TFLOP/s of TF32 "
                         f"({tf32 / 1e9:.2f} GFLOP, bound "
                         f"{1e3 * tf32 / fp.TF32_FLOPS_PER_S:.4f} ms)")
        pair_ms = sum(times["dq"]["kernel"] + times["dkv"]["kernel"]) / 2
        print(f"flash_attention_bwd B {b}, S {s}, H {H}, D {D}, causal: "
              f"dQ: {report(times['dq'])}; dK/dV: {report(times['dkv'])}; "
              f"dQ + dK/dV {pair_ms:.4f} ms; sdpa backward {both - fwd:.4f}"
              f" ms (fwd+bwd {both:.4f}, fwd {fwd:.4f}); "
              + "; ".join(rates)
              + f"; largest share of the 1e-4 limit dQ {limit[0]:.4f}, dK "
              f"{limit[1]:.4f}, dV {limit[2]:.4f}; two calls bit-identical "
              f"{repeat}{note}; against float64: kernels dQ "
              f"{f64['kernel'][0]:.4f}, dK {f64['kernel'][1]:.4f}, dV "
              f"{f64['kernel'][2]:.4f}; plain dQ {f64['plain'][0]:.4f}, dK "
              f"{f64['plain'][1]:.4f}, dV {f64['plain'][2]:.4f} [{card}]",
              flush=True)
        if (b, s) == SHAPES[-1]:
            print(f"sdpa backward kernels at B {b}, S {s}: "
                  f"{sdpa_bwd_kernels(qt, kt, vt, dot)}")
        del q, k, v, do, lse, delta, dq, dk, dv, out, dk_out, dv_out
        del qt, kt, vt, dot
    return 0


if __name__ == "__main__":
    sys.exit(main())
