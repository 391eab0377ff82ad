"""Run the bfloat16 bottleneck-chain kernels of
``paddle_tpu_torch/csrc/fused_block_bf16.cu``, forward and backward, on
the CPU, before any GPU sees them.

``scripts/emulate_fused_lstm_cpu.py``'s harness (every thread of a launch
a fiber of one host thread, yielding at ``__syncthreads`` and at each
warp exchange; ``<<<...>>>`` launches block after block; each block's
dynamic shared memory filled with 0xff bytes, NaN in bf16 and in float32,
so that a read before a store shows), with the source's block of PTX
replaced: ``mma.sync`` m16n8k16 bf16 as
``scripts/emulate_fused_lstm_bf16_cpu.py`` emulates it (PTX's A, B and C
fragment layouts, the 16 products summed in double onto the accumulator
and truncated toward zero), and ``ldmatrix`` x4 (plain and ``.trans``) an
exchange of the warp's row addresses, each lane taking PTX's fragment of
each 8 x 8 matrix; a row address off 16 bytes, or outside the block's
shared memory, is counted, and so is an ``__ldg`` off its type's size.
``csrc/fused_block.cuh`` (the fixed-order passes) is rewritten the same
way. Built with ``g++ -std=c++20`` into ``paddle_tpu_torch/_build/``.

The wrappers themselves (``fused_block.conv1x1_stats_bf16``,
``conv3x3_norm_stats_bf16``, ``norm_relu_moments_bf16``,
``conv1x1_bn_residual_bf16``; ``bwd_reduce3_bf16``, ``bwd_apply3_bf16``,
``bwd_mid_bf16``, ``bwd_final_bf16``) are called on CPU tensors under that
script's ``emulated`` (``build.bind`` pointed at the emulation,
``build.sm_count`` at ``--sms``, every output allocated full of NaN), at
each N,Cin,C,H[,W] given, on
the chain's inputs made as it makes them (x >= 0 and He-scaled weights
rounded to bf16; each stage's input the plain version of the stage
before; BN folds from the plain sums; the backward's on one run of the
plain chain's backward from a bf16 cotangent of out and random
cotangents of the six batch statistics). Printed: each y's largest share
of the bf16 limit 2^-7 max|plain| + 2^-7 |plain| against the plain
version and the share of its elements that differ at all; each sum's
largest share of its limit (the float32 order, 1e-5 of the sum of its
terms' magnitudes, plus what the flipped y move: the sum of |y - plain
y|), and its share of the float32 limit alone; whether M2 is exactly symmetric; for the backward, g3 bit for bit,
g2, g1 and dx as y, the sums of g2 and g1 as y's and the products over
N·S (P, Σg3, dW1; dtaps against its float64 product) within STATS_RTOL
of their terms' magnitudes, as ``chip_smoke.bf16_bwd_readings`` holds
them in phase 3;
whether a second call gives the same bits; and the counts of misaligned
or stray accesses. Exits 1 if any check misses.

    python scripts/emulate_fused_block_bf16_cpu.py 2,32,16,8 2,128,64,14 \\
        1,256,64,16 3,128,128,7 2,64,128,6,10 8,128,64,5 2,48,80,9
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import emulate_fused_lstm_bf16_cpu as lstm_bf16_emu  # noqa: E402
import emulate_fused_lstm_cpu as lstm_emu  # noqa: E402
import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

SOURCE = "fused_block_bf16.cu"
BF16_REL = 2.0 ** -7
STATS_RTOL = 1e-5
DASHES = "// " + "-" * 77

# ldmatrix x4: lanes 8 j .. 8 j + 7 give matrix j's rows; lane 4 g + t
# takes row g, elements 2 t and 2 t + 1 of each matrix (with .trans, rows
# 2 t and 2 t + 1 of column g)
LDSM = r"""
inline int emu_outside = 0;
template <bool kTrans>
inline void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_cur->blk->warps[threadIdx.x >> 5];
  const char* lo = reinterpret_cast<const char*>(emu_cur->blk->smem.data());
  const char* at = reinterpret_cast<const char*>(p);
  emu_misaligned += reinterpret_cast<uintptr_t>(p) % 16 != 0;
  emu_outside += at < lo || at + 16 > lo + 4 * emu_cur->blk->smem.size();
  W.p[lane] = p;
  W.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int j = 0; j < 4; ++j) {
    const uint32_t a = kTrans ? W.p[8 * j + 2 * t][g] : W.p[8 * j + g][2 * t];
    const uint32_t b = kTrans ? W.p[8 * j + 2 * t + 1][g]
                              : W.p[8 * j + g][2 * t + 1];
    r[j] = a | b << 16;
  }
  W.bar.arrive_and_wait();
}
"""

# fused_block.cuh's mask rounds its product and its sum (the CUDA
# intrinsics)
ROUNDED = r"""
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
"""

UNIT = r"""
#include "fused_block_bf16.cu"
extern "C" int emu_take_outside() {
  const int n = emu_outside;
  emu_outside = 0;
  return n;
}
"""


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "cuda_emu.h"\n')
    if name == SOURCE:
        a = text.index("// ---- bf16 tensor-core product and its fragment")
        b = text.index(DASHES, a)
        text = text[:a] + lstm_bf16_emu.MMA + LDSM + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    text = emu.LAUNCH.sub(emu._launch, text)
    if "asm" in re.sub(r"//.*", "", text) or "<<<" in text:
        raise RuntimeError(f"{name}: a launch or inline assembly is left")
    return text


def emu_header() -> str:
    h = lstm_emu.EMU_H + lstm_bf16_emu.VECTORS + ROUNDED
    for old, new in (
            ("  float c[32][4];\n",
             "  float c[32][4];\n  const uint16_t* p[32];\n"),
            ("template <class T> inline T __ldg(const T* p) { return *p; }",
             "extern int emu_misaligned;\n"
             "template <class T> inline T __ldg(const T* p) {\n"
             "  emu_misaligned += reinterpret_cast<uintptr_t>(p) % sizeof(T)"
             " != 0;\n  return *p;\n}")):
        if old not in h:
            raise RuntimeError(f"the harness has no {old!r}")
        h = h.replace(old, new)
    return h


def compile_library(out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in ("fused_block.cuh", SOURCE):
        (out / name).write_text(rewrite(name))
    (out / "cuda_emu.h").write_text(emu_header())
    rt = lstm_emu.EMU_RT.replace(
        "std::numeric_limits<float>::quiet_NaN()",
        "__uint_as_float(0xffffffffu)")
    if rt == lstm_emu.EMU_RT:
        raise RuntimeError("the shared-memory fill was not found")
    (out / "emu_rt.cpp").write_text(rt)
    (out / "unit.cpp").write_text(UNIT)
    lib = out / "fused_block_bf16_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    "-o", str(lib), "unit.cpp", "emu_rt.cpp"], cwd=out,
                   check=True)
    return ctypes.CDLL(str(lib))


def chain_inputs(n, cin, c, h, w, seed):
    """The chain's inputs in bf16 (a block input >= 0, He-scaled weights)
    and its float32 BN parameters, from a seed."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    bf = torch.bfloat16
    return dict(x=torch.rand(n, cin, h * w, generator=gen).to(bf),
                w1=(randn(c, cin) * (2 / cin) ** 0.5).to(bf),
                taps=(randn(9, c, c) * (2 / (9 * c)) ** 0.5).to(bf),
                w3=(randn(cin, c) * (2 / c) ** 0.5).to(bf),
                gam=[1 + 0.2 * randn(k) for k in (c, c, cin)],
                bet=[0.2 * randn(k) for k in (c, c, cin)])


def y_share(got, want):
    """(largest share of the bf16 limit, share of elements that differ)."""
    got, want = got.float(), want.float()
    lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    return (float(((got - want).abs() / lim.clamp_min(1e-30)).max()),
            float((got != want).float().mean()))


def sum_share(got, want, terms, moved=0.0):
    """Largest share of a sum's limit STATS_RTOL Σ|terms| + moved."""
    lim = STATS_RTOL * terms + moved
    return float(((got - want).abs() / lim.clamp_min(1e-30)).max())


BWD = ("bwd_reduce3", "bwd_apply3", "bwd_mid", "bwd_final")


def bwd_case(lib, sms, d, h, seed):
    """The four bf16 backward kernels against their plain versions, on the
    inputs of one run of the plain chain's backward from a bf16
    cotangent of out and random cotangents of the six batch statistics
    (chip_smoke.chain_bwd_inputs), at phase 3's limits
    (chip_smoke.bf16_bwd_readings): (ok, [notes], [same bits])."""
    gen = torch.Generator().manual_seed(seed + 1000)
    n, cin, s = d["x"].shape
    c = d["w1"].shape[0]
    dout = torch.randn(n, cin, s, generator=gen).to(torch.bfloat16)
    cots = [0.1 * torch.randn(k, generator=gen)
            for k in (c, c, c, c, cin, cin)]
    args = cs.chain_bwd_inputs(torch, fb, d, dout, h, "_bf16", cots)
    notes, ok, same = [], True, []
    for name in BWD:
        fn = getattr(fb, name + "_bf16")
        with lstm_emu.emulated(lib, sms):
            got = fn(*args[name])
            again = fn(*args[name])
        same.append(all(torch.equal(a, b) for a, b in zip(got, again)))
        want = getattr(fb, name + "_reference")(*args[name])
        for what, (share, differ) in cs.bf16_bwd_readings(
                torch, fb, name, args[name], got, want).items():
            notes.append(f"{what} {share:.4f}" + (
                "" if differ is None else f" (differ {differ:.5f})"))
            ok = ok and share <= 1
    return ok, notes, same


def case(lib, sms, n, cin, c, h, w, seed):
    d = chain_inputs(n, cin, c, h, w, seed)
    x, w1, taps, w3 = d["x"], d["w1"], d["taps"], d["w3"]
    m = n * h * w
    out, ok = [], True

    def run(fn, *args):
        with lstm_emu.emulated(lib, sms):
            first = fn(*args)
            again = fn(*args)
        same = all(torch.equal(a, b) for a, b in zip(first, again)) \
            if isinstance(first, tuple) else torch.equal(first, again)
        return first, same

    def stage_y(name, y, ry, s, q, rs, rq):
        nonlocal ok
        share, differ = y_share(y, ry)
        moved = (y.float() - ry.float()).abs()
        yf = ry.float()
        ss = sum_share(s, rs, yf.abs().sum(dim=(0, 2)), moved.sum(dim=(0, 2)))
        sq = sum_share(q, rq, (yf * yf).sum(dim=(0, 2)),
                       (moved * (y.float().abs() + yf.abs())).sum(dim=(0, 2)))
        alone = max(sum_share(s, rs, yf.abs().sum(dim=(0, 2))),
                    sum_share(q, rq, (yf * yf).sum(dim=(0, 2))))
        out.append(f"{name} y {share:.4f} (differ {differ:.5f}), Σ {ss:.4f}, "
                   f"Σ² {sq:.4f} (of the float32 limit alone {alone:.4f})")
        ok = ok and share <= 1 and ss <= 1 and sq <= 1 \
            and bool(torch.isfinite(y.float()).all())

    (y1, s1, q1), same1 = run(fb.conv1x1_stats_bf16, x, w1)
    ry1, rs1, rq1 = fb.conv1x1_stats_reference(x, w1)
    stage_y("conv1x1_stats", y1, ry1, s1, q1, rs1, rq1)
    _, _, sc1, sh1 = fb._bn_fold(rs1, rq1, m, d["gam"][0], d["bet"][0])
    (y2, s2, q2), same2 = run(fb.conv3x3_norm_stats_bf16, ry1, taps, sc1,
                              sh1, h)
    ry2, rs2, rq2 = fb.conv3x3_norm_stats_reference(ry1, taps, sc1, sh1, h)
    stage_y("conv3x3_norm_stats", y2, ry2, s2, q2, rs2, rq2)
    _, _, sc2, sh2 = fb._bn_fold(rs2, rq2, m, d["gam"][1], d["bet"][1])
    (sum_h, m2h), same3 = run(fb.norm_relu_moments_bf16, ry2, sc2, sh2)
    rsum_h, rm2h = fb.norm_relu_moments_reference(ry2, sc2, sh2)
    # h >= 0: Σh and M2 are their terms' magnitudes summed
    sh_share = sum_share(sum_h, rsum_h, rsum_h)
    m2_share = sum_share(m2h, rm2h, rm2h)
    sym = torch.equal(m2h, m2h.T)
    out.append(f"norm_relu_moments Σh {sh_share:.4f}, M2 {m2_share:.4f}, "
               f"symmetric {sym}")
    ok = ok and sh_share <= 1 and m2_share <= 1 and sym
    _, _, sc3, sh3 = fb._bn3_fold(w3, rsum_h, rm2h, m, d["gam"][2],
                                  d["bet"][2])
    args = (ry2, x, sc2, sh2, w3, sc3, sh3)
    y4, same4 = run(fb.conv1x1_bn_residual_bf16, *args)
    share, differ = y_share(y4, fb.conv1x1_bn_residual_reference(*args))
    out.append(f"conv1x1_bn_residual out {share:.4f} (differ {differ:.5f})")
    ok = ok and share <= 1 and bool(torch.isfinite(y4.float()).all())
    same = [same1, same2, same3, same4]
    bok, bnotes, bsame = bwd_case(lib, sms, d, h, seed)
    ok = ok and bok
    out.append("backward " + ", ".join(bnotes))
    same += bsame
    misaligned = lib.emu_take_misaligned()
    outside = lib.emu_take_outside()
    print(f"N {n}, Cin {cin}, C {c}, {h}x{w}: " + "; ".join(out)
          + f"; a second call the same bits {same}; misaligned accesses "
          f"{misaligned}; ldmatrix rows outside shared memory {outside}",
          flush=True)
    return ok and all(same) and not misaligned and not outside


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="N,Cin,C,H[,W]")
    ap.add_argument("--sms", type=int, default=132)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "fused_block_bf16_emu")
    ok = []
    for i, shape in enumerate(args.shapes):
        dims = [int(v) for v in shape.split(",")]
        n, cin, c, h = dims[:4]
        w = dims[4] if len(dims) > 4 else h
        ok.append(case(lib, args.sms, n, cin, c, h, w, args.seed + i))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
