"""Run the bfloat16 LSTM kernels of
``paddle_tpu_torch/csrc/fused_lstm_bf16.cu`` (the forward, or with
``--bwd`` the backward) on the CPU, before any GPU sees them.

``scripts/emulate_fused_lstm_cpu.py``'s harness (every thread of a
cooperative launch a fiber of one host thread, yielding at
``__syncthreads``, ``__syncwarp``, the mma exchange and each turn of the
grid barrier's spin; ``tf32_mma.cuh``'s copies as a per-thread queue that
lands at ``wait_group``; ``<<<...>>>`` launches block after block), with
the source's block of bf16 ``mma.sync`` replaced: m16n8k16 an exchange of
the warp's fragments (PTX's bf16 A, B and C layouts), the products summed
in double onto the accumulator and truncated toward zero. Each block's
dynamic shared memory is filled with 0xff bytes (NaN in bf16 and in
float32), so that a read before its copy lands shows. Two libraries are
built with ``g++ -std=c++20`` into ``paddle_tpu_torch/_build/``: one whose
copies land at ``wait_group``, one whose copies land as they are issued.

The wrapper ``fused_lstm.lstm_seq_fwd_bf16`` itself is called on CPU
tensors (``build.bind`` pointed at the emulation, the emulated card at
``--sms`` SMs of one block, every output allocated full of NaN) at each
T,B,H[,r] given (r: ragged lengths in [1, T], 1 and T among them), on
bf16 inputs from a seed: the plan it took, the largest share of the
limit 2^-7 max|plain| + 2^-7 |plain| of rs and cs against
``lstm_seq_fwd_reference`` on the same bf16 inputs, and the number of
elements that differ at all; whether a second call gives the same bits,
whether copies landing at once do, whether the barrier counters are back
at 0, and how many 16-byte copies had a source or destination off 16
bytes. Last, a cooperative launch whose grid the emulated card cannot
hold must raise.

With ``--bwd`` the wrapper ``fused_lstm.lstm_seq_bwd_bf16`` instead, on
the forward's bf16 carries (``lstm_seq_fwd_reference``) and bf16
cotangents from the seed: dx, dw, db, dr0 and dc0 against
``lstm_seq_bwd_reference`` at the same limit, and the same checks. Exits
1 if any check misses.

    python scripts/emulate_fused_lstm_bf16_cpu.py 5,3,8 6,4,24,r 4,8,128 \\
        5,17,128,r 3,40,136,r 3,2,512 2,64,512,r
    python scripts/emulate_fused_lstm_bf16_cpu.py --sms 8 4,70,24,r
    python scripts/emulate_fused_lstm_bf16_cpu.py --bwd 5,3,8,r 9,17,40,r \\
        4,8,128 3,40,136,r 3,2,512,r 2,64,512,r
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

import emulate_fused_lstm_cpu as lstm_emu  # noqa: E402
import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as fl  # noqa: E402

SOURCE = "fused_lstm_bf16.cu"
BF16_REL = 2.0 ** -7
DASHES = "// " + "-" * 77

# the source's bf16 mma, emulated: element (r, k) of A is half k % 2 of
# register r / 8 + 2 (k / 8) of lane 4 (r % 8) + (k % 8) / 2; (k, n) of B
# half k % 2 of register k / 8 of lane 4 n + (k % 8) / 2; C's (g + 8 (i /
# 2), 2 t + i % 2) register i of lane 4 g + t
MMA = r"""// ---- bf16 tensor-core product (emulated)
inline float emu_half(uint32_t r, int k) {
  return __uint_as_float(((k & 1) ? r >> 16 : r & 0xffffu) << 16);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_cur->blk->warps[threadIdx.x >> 5];
  for (int i = 0; i < 4; ++i) {
    W.a[lane][i] = a[i];
    W.c[lane][i] = d[i];
  }
  W.b[lane][0] = b0;
  W.b[lane][1] = b1;
  W.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    double s = W.c[lane][i];
    for (int k = 0; k < 16; ++k)
      s += (double)emu_half(W.a[4 * (r & 7) + (k & 7) / 2][(r >> 3) + 2 * (k >> 3)], k)
           * (double)emu_half(W.b[4 * n + (k & 7) / 2][k >> 3], k);
    float f = (float)s;
    if (std::fabs((double)f) > std::fabs(s)) f = std::nextafter(f, 0.f);
    out[i] = f;
  }
  W.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
"""

VECTORS = r"""
struct __attribute__((aligned(8))) uint2 { unsigned x, y; };
struct __attribute__((aligned(16))) uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
"""


def rewrite_source() -> str:
    text = (build.CSRC / SOURCE).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "cuda_emu.h"\n')
    for marker, body in (("// ---- bf16 tensor-core product", MMA),
                         ("// ---- grid barrier", lstm_emu.GRID)):
        a = text.index(marker)
        b = text.index(DASHES, a)
        text = text[:a] + body + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    text = emu.LAUNCH.sub(emu._launch, text)
    if "asm" in re.sub(r"//.*", "", text) or "<<<" in text:
        raise RuntimeError(f"{SOURCE}: a launch or inline assembly is left")
    return text


def compile_library(out: Path, eager: bool) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    (out / "tf32_mma.cuh").write_text(lstm_emu.rewrite("tf32_mma.cuh"))
    (out / SOURCE).write_text(rewrite_source())
    (out / "cuda_emu.h").write_text(lstm_emu.EMU_H + VECTORS)
    rt = lstm_emu.EMU_RT.replace(
        "std::numeric_limits<float>::quiet_NaN()",
        "__uint_as_float(0xffffffffu)")
    if rt == lstm_emu.EMU_RT:
        raise RuntimeError("the shared-memory fill was not found")
    (out / "emu_rt.cpp").write_text(rt)
    (out / "unit.cpp").write_text(f'#include "{SOURCE}"\n')
    lib = out / "fused_lstm_bf16_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    *(["-DEMU_EAGER"] if eager else []), "-o", str(lib),
                    "unit.cpp", "emu_rt.cpp"], cwd=out, check=True)
    return ctypes.CDLL(str(lib))


def inputs(t, b, h, ragged):
    """The f32 harness's inputs, rounded to bf16."""
    return [v.bfloat16() for v in lstm_emu.inputs(t, b, h, ragged)]


def bwd_inputs(t, b, h, ragged):
    x, w, bias, mask, r0, c0 = inputs(t, b, h, ragged)
    rs, cs = fl.lstm_seq_fwd_reference(x, w, bias, mask, r0, c0)
    gen = torch.Generator().manual_seed(7 * t + b + h)
    return (x, w, bias, mask, torch.cat([r0[None], rs[:-1]]),
            torch.cat([c0[None], cs[:-1]]),
            torch.randn(t, b, h, generator=gen).bfloat16(),
            torch.randn(t, b, h, generator=gen).bfloat16())


def share(got, want) -> float:
    got, want = got.float(), want.float()
    lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    return float(((got - want).abs() / lim).max())


def case(libs, sms, t, b, h, ragged, bwd=False):
    if bwd:
        args, run, plan = (bwd_inputs(t, b, h, ragged), fl.lstm_seq_bwd_bf16,
                           fl._bwd_plan_of)
        want = fl.lstm_seq_bwd_reference(*args)
        names = ("dx", "dw", "db", "dr0", "dc0")
    else:
        args, run, plan = (inputs(t, b, h, ragged), fl.lstm_seq_fwd_bf16,
                           fl._plan_of)
        want = fl.lstm_seq_fwd_reference(*args)
        names = ("rs", "cs")
    with lstm_emu.emulated(libs["wait"], sms):
        took = plan(b, h, None, torch.bfloat16)
        got = run(*args)
        again = run(*args)
        counters = [v.clone() for v in fl._barriers.values()]
    with lstm_emu.emulated(libs["eager"], sms):
        eager = run(*args)
    misaligned = sum(lib.emu_take_misaligned() for lib in libs.values())
    shares = {n: share(g, w) for n, g, w in zip(names, got, want)}
    differ = {n: int((g.float() != w.float()).sum())
              for n, g, w in zip(names, got, want)}
    dtypes = [str(g.dtype).rsplit(".", 1)[-1] for g in got]
    same = [all(torch.equal(x, y) for x, y in zip(got, o))
            for o in (again, eager)]
    zero = all(int(c.abs().sum()) == 0 for c in counters)
    print(f"{'bwd' if bwd else 'fwd'} T {t}, B {b}, H {h}, "
          f"{'ragged' if ragged else 'full length'}: {took}; outputs "
          f"{dtypes}; largest share of the limit "
          + ", ".join(f"{n} {s:.4f}" for n, s in shares.items())
          + "; elements that differ " + ", ".join(
              f"{n} {k}" for n, k in differ.items())
          + f"; a second call the same bits {same[0]}; copies landing at "
          f"once the same bits {same[1]}; barrier counters back at 0 "
          f"{zero}; misaligned 16-byte copies {misaligned}", flush=True)
    return max(shares.values()) <= 1 and all(same) and zero and not misaligned


def refused(lib, sms, bwd=False) -> bool:
    """A plan whose grid the emulated card (one SM) cannot hold: the
    cooperative launch is refused and the wrapper raises."""
    if bwd:
        args, run, plan = (bwd_inputs(3, 4, 64, False), fl.lstm_seq_bwd_bf16,
                           fl._bwd_plan_of)
    else:
        args, run, plan = (inputs(3, 4, 64, False), fl.lstm_seq_fwd_bf16,
                           fl._plan_of)
    lib.emu_set_card(1, 1)
    try:
        with lstm_emu.emulated(lib, 132):
            plan(4, 64, None, torch.bfloat16)   # a plan for 132 SMs ...
            try:
                run(*args)    # ... launched on one
            except RuntimeError as e:
                print(f"a grid larger than the card: raised ({e})")
                return True
    finally:
        lib.emu_set_card(sms, 1)
    print("a grid larger than the card: no error")
    return False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="T,B,H[,r]")
    ap.add_argument("--sms", type=int, default=132)
    ap.add_argument("--bwd", action="store_true",
                    help="the backward (lstm_seq_bwd_bf16) instead")
    args = ap.parse_args()
    torch.set_num_threads(1)
    libs = {name: compile_library(build.BUILD_DIR / f"lstm_bf16_emu_{name}",
                                  name == "eager")
            for name in ("wait", "eager")}
    for lib in libs.values():
        lib.emu_set_card.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.emu_set_card(args.sms, 1)
    ok = []
    for shape in args.shapes:
        parts = shape.split(",")
        t, b, h = map(int, parts[:3])
        if not set(parts[3:]) <= {"r"}:
            ap.error(f"{shape}: the one flag is r (ragged)")
        ok.append(case(libs, args.sms, t, b, h, "r" in parts[3:], args.bwd))
    ok.append(refused(libs["wait"], args.sms, args.bwd))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
