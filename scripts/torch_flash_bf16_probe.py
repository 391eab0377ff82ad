"""The bf16 flash-attention kernels of this tree against another tree's,
on one GPU.

Builds ``paddle_tpu_torch/csrc/flash_attention_bf16.cu`` of this tree
and, with ``--parent DIR``, of another tree (DIR holds its
``paddle_tpu_torch/csrc``; e.g. the parent unpacked by ``git archive``),
prints each build's registers and spills (ptxas) and, for this tree, how
many HGMMA (wgmma) and HMMA (mma.sync) instructions each kernel's SASS
holds (cuobjdump), and whether the forward's and dK/dV's SASS is the
other tree's, function by function. Then, at H 8, D 256, causal and each
(B, S) of SHAPES (chip_smoke.py's FLASH_BF16_SHAPES), for each of the
forward, dQ and dK/dV:

* this tree's outputs against the plain versions (bf16 outputs within
  2^-7 max|plain| + 2^-7 |plain|, lse within 1e-4, as phase 3 holds
  them), and two calls bit-identical;
* with ``--parent``, whether the forward's and dK/dV's outputs are the
  other tree's, bit for bit;
* each build's time by CUDA events, in turns (this tree, the other, the
  other, this tree), its bf16 rate (2 D operations a product per visible
  (query, key) pair: two products in the forward, three in dQ, four in
  dK/dV), and its bound (the larger of its bytes at 3.35 TB/s and its
  operations at 989 TFLOP/s);
* PyTorch's scaled_dot_product_attention in bf16: its forward, and its
  backward alone (the graph built once, then torch.autograd.grad with
  retain_graph over it).

Beside them, timed in the same turns, ablations of this tree's source
(substitutions in copies; they compute nothing useful): the forward
without its O store (``no O store``), without its softmax (``no
softmax``: alpha 1, S packed as it is), without its P V products (``no P
V``); dQ without its dS K products (``no dS K``), without p's way through
shared memory (``no p exchange``: consumer 0 writes no p but still forms
it, summed into a register that is stored once, consumer 1 reads none
and forms dS from dP alone; the named barriers stay), with the rings of
the first design, 2 K tiles and 2 V tiles (``K ring 2, V ring 2``: the
same shared memory, K's tile reloaded a tile sooner); and the three
kernels with their grids in one group of heads (``ungrouped``:
heaviest first over all (batch, head)s).

Run from the repository root on a machine with the CUDA toolkit:
``python scripts/torch_flash_bf16_probe.py [--parent DIR]``.
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
import torch_flash_fwd_probe as fwd_probe  # noqa: E402

SHAPES = ((1, 128), (1, 333), (1, 1024), (8, 1024))   # (batch, sequence)
H, D = 8, 256
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_REL, LSE_TOL = 2.0 ** -7, 1e-4
SOURCE = "flash_attention_bf16.cu"
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY = {"fwd": ("flash_attention_fwd_bf16", (P,) * 5),
         "dq": ("flash_attention_bwd_dq_bf16", (P,) * 7),
         "dkv": ("flash_attention_bwd_dkv_bf16", (P,) * 8)}
PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}
# name: (substitutions in this tree's source, the kernels they change)
ABLATIONS = {
    "no O store": ((("      sm90::tma_store_4d(&to, sQ + cb * "
                     "sm90::kBoxBytes, 64 * cb, hd, r0, b);",
                     "      (void)cb;"),), ("fwd",)),
    "no softmax": (tuple((f"      online_softmax<{m}>(sc, m, l, alpha, qpos, "
                          f"k0, t, sk, causal, scale2);",
                          "      alpha[0] = alpha[1] = 1.f;")
                         for m in ("true", "false")), ("fwd",)),
    "no P V": ((("    sm90::wgmma_rs<D, 1>(acc, pa[kk], "
                 "sm90::desc_mn(sV, kk), 1);", "    (void)kk;"),), ("fwd",)),
    "no dS K": ((("    sm90::wgmma_ss<D / 2, 1>(acc, sm90::desc_k(sS, kk),\n"
                  "                             sm90::desc_mn(sKh, kk), 1);",
                  "    (void)kk;"),
                 ("    sm90::wgmma_rs<D / 2, 1>(acc, da[kk], "
                  "sm90::desc_mn(sKh, kk), 1);", "    (void)kk;")), ("dq",)),
    "no p exchange": ((("    float sc[32];  // S, then p",
                        "    float sc[32];  // S, then p\n    float sink = 0.f;"),
                       ("        sP[j * 128 + tid] = make_float4(sc[4 * j], "
                        "sc[4 * j + 1],\n"
                        "                                        sc[4 * j + 2], "
                        "sc[4 * j + 3]);",
                        "        sink += sc[4 * j] + sc[4 * j + 1] + "
                        "sc[4 * j + 2] + sc[4 * j + 3];"),
                       ("    release(empty_k(last));\n  } else {",
                        "    release(empty_k(last));\n    if (sink == 1.5f) "
                        "sP[tid] = make_float4(sink, 0.f, 0.f, 0.f);\n"
                        "  } else {"),
                       ("          dp[4 * j + e] = pe[e] * (dp[4 * j + e] - "
                        "rv[e >> 1]) * scale;",
                        "          dp[4 * j + e] = (dp[4 * j + e] - "
                        "rv[e >> 1]) * scale + 0.f * pe[e];"),
                       ("        const float4 p = sP[j * 128 + tid];",
                        "        const float4 p = make_float4(0.f, 0.f, 0.f, "
                        "0.f);")), ("dq",)),
    "K ring 2, V ring 2": ((("constexpr int kDqKStages = 3;",
                            "constexpr int kDqKStages = 2;"),
                           ("constexpr int kDqVStages = 1;",
                            "constexpr int kDqVStages = 2;")), ("dq",)),
    "ungrouped": ((("constexpr long kL2Budget = 24l << 20;",
                    "constexpr long kL2Budget = 1l << 40;"),),
                  ("fwd", "dq", "dkv")),
}
# the kernels that stay the parent's, SASS and outputs
UNCHANGED = ("fwd", "dkv")


def entry_points(lib: Path) -> dict:
    """{part: the library's entry point of that kernel}."""
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for part, (symbol, ptrs) in ENTRY.items():
        f = getattr(cdll, symbol)
        f.argtypes = list(ptrs) + [I] * 5 + [FL, I, P]
        f.restype = ctypes.c_int
        fns[part] = f
    return fns


def hgmma_counts(lib: Path) -> str:
    """HGMMA and HMMA instructions in each bf16 kernel's SASS."""
    funcs = ab.sass(lib)
    return "; ".join(f"{name.split('_kernel')[0].split('flash_bf16_')[-1]}"
                     f"<{name.split('ILi')[1].split('E')[0]}> "
                     f"{text.count('HGMMA')} HGMMA, "
                     f"{text.count('HMMA')} HMMA"
                     for name, text in sorted(funcs.items())
                     if "flash_bf16_" in name)


def bf16_share(got, want) -> float:
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    return float(((got - want).abs() / lim).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a tree whose bf16 flash kernels to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    variants = {"kernel": ()}
    variants.update({name: subs for name, (subs, _) in ABLATIONS.items()})
    built = fwd_probe.compile_variants(
        build.BUILD_DIR / "flash_bf16_probe", args.parent, source=SOURCE,
        variants=variants, symbol=ENTRY["fwd"][0],
        argtypes=ENTRY["fwd"][1] + (I,) * 5 + (FL, I, P))
    libs = {name: lib for name, (_, lib) in built.items()}
    print(f"Tensor-core instructions in this tree's SASS: "
          f"{hgmma_counts(libs['kernel'])}")
    if "parent" in libs:
        for part in UNCHANGED:
            print(fwd_probe.same_sass((libs["parent"], libs["kernel"]),
                                      f"flash_bf16_{part}_kernel"),
                  "(this tree against the parent's)")
    fns = {name: entry_points(lib) for name, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s in SHAPES:
        q, k, v, do = (torch.randn(b, s, H, D, device="cuda",
                                   generator=gen).bfloat16()
                       for _ in range(4))
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        delta = fa.flash_attention_bwd_delta(ro, do)
        want = {"fwd": (ro, rlse), "dq": (fa.flash_attention_bwd_dq_reference(
                    q, k, v, do, rlse, delta, causal=True),),
                "dkv": fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, rlse, delta, causal=True)}
        outs = {"fwd": (torch.empty_like(q),
                        torch.empty(b * H, s, device="cuda")),
                "dq": (torch.empty_like(q),),
                "dkv": (torch.empty_like(k), torch.empty_like(v))}
        ins = {"fwd": (q, k, v), "dq": (q, k, v, do, rlse, delta),
               "dkv": (q, k, v, do, rlse, delta)}
        tail = (b, H, s, s, D, D ** -0.5, 1, stream)

        def launcher(name, part):
            ptrs = [x.data_ptr() for x in ins[part] + outs[part]]
            f = fns[name][part]

            def call():
                err = f(*ptrs, *tail)
                if err:
                    raise RuntimeError(f"{name} {part}: CUDA error {err}")
            return call

        checks = {}
        for part in ENTRY:
            launcher("kernel", part)()
            first = [x.clone() for x in outs[part]]
            launcher("kernel", part)()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(first, outs[part]))
            share = [bf16_share(x, w) for x, w in zip(first, want[part])
                     if x.dtype == torch.bfloat16]
            if part == "fwd":
                share.append(float(((first[1] - rlse).abs()
                                    / (LSE_TOL + LSE_TOL * rlse.abs())).max()))
            assert max(share) <= 1 and same, (part, share, same)
            note = ""
            if part in UNCHANGED and "parent" in fns:
                launcher("parent", part)()
                torch.cuda.synchronize()
                same_parent = all(torch.equal(x, y)
                                  for x, y in zip(outs[part], first))
                note = f"; the parent's outputs bit-identical {same_parent}"
            checks[part] = (f"largest share of the limit "
                            f"{' / '.join(f'{x:.4f}' for x in share)}; two "
                            f"calls bit-identical {same}{note}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_fwd = c3.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        graph = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        dot = do.transpose(1, 2)
        sdpa_bwd = c3.cuda_ms(lambda: torch.autograd.grad(
            graph, (qg, kg, vg), dot, retain_graph=True))
        del graph, qg, kg, vg
        pairs = b * H * s * (s + 1) // 2
        elems, rowvec = b * s * H * D, 4 * b * H * s
        nbytes = {"fwd": 2 * 4 * elems + rowvec,
                  "dq": 2 * 5 * elems + 2 * rowvec,
                  "dkv": 2 * 6 * elems + 2 * rowvec}
        for part in ENTRY:
            timed = [name for name in fns if name not in ABLATIONS
                     or part in ABLATIONS[name][1]]
            times = {name: [] for name in timed}
            for order in (timed, timed[::-1]):
                for name in order:
                    times[name].append(c3.cuda_ms(launcher(name, part)))
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            flops = PRODUCTS[part] * 2 * D * pairs
            bound = 1e3 * max(nbytes[part] / HBM_BYTES_PER_S,
                              flops / BF16_FLOPS_PER_S)
            by = ("bytes" if nbytes[part] / HBM_BYTES_PER_S
                  >= flops / BF16_FLOPS_PER_S else "operations")
            print(f"{ENTRY[part][0]} B {b}, S {s}, H {H}, D {D}, causal: "
                  + "; ".join(f"{name} {m:.4f} ms ("
                              + ", ".join(f"{t:.4f}" for t in times[name])
                              + f", {flops / m / 1e9:.1f} TFLOP/s)"
                              for name, m in ms.items())
                  + (f"; this tree / the parent "
                     f"{ms['kernel'] / ms['parent']:.3f}"
                     if "parent" in ms else "")
                  + f"; bound {bound:.4f} ms ({by}); sdpa bf16 "
                  + (f"forward {sdpa_fwd:.4f}" if part == "fwd" else
                     f"backward alone {sdpa_bwd:.4f}")
                  + f" ms; {checks[part]} [{card}]", flush=True)
        del q, k, v, do, ro, rlse, delta, want, outs, ins
    return 0


if __name__ == "__main__":
    sys.exit(main())
