"""Run the bfloat16 flash-attention kernels of ``paddle_tpu_torch/csrc/
flash_attention_bf16.cu`` (forward, dQ, dK/dV) on the CPU, before any GPU
sees them.

The harness of ``scripts/emulate_flash_bwd_cpu.py``: a copy of the source
and of ``common.cuh``, rewritten for g++ (threads for a block's threads,
``gridDim`` set by each launch, a per-thread queue of copies that lands at
``wait_group``, shared memory filled with 0xff bytes, a NaN in bf16 and in
float32, so that a read before its copy lands shows). The source's block
of copy, conversion and mma helpers is replaced: ``mma.sync`` m16n8k16
bf16 becomes an exchange of the warp's fragments through a per-warp
barrier (PTX's fragment layouts) whose products are summed in double and
rounded to float32, ``cvt.rn.bf16x2.f32`` a round to nearest even on the
bits, the xor shuffle an exchange through the same barrier. Two libraries
are built with ``g++ -std=c++20`` into ``paddle_tpu_torch/_build/``: one
whose copies land at ``wait_group``, one whose copies land as they are
issued (a copy issued before its buffer's last reader is done then
shows). The entry points are called through ``ctypes`` on CPU tensors at
each B,Sq,Sk,H,D,causal given, bf16 inputs from a seed, the backward
from the plain forward's O and lse: the largest share of the kernels'
limits (2^-7 max|plain| + 2^-7 |plain| for O, dQ, dK and dV; 1e-4 for
lse) against the plain versions, whether a second call gives the same
bits, and whether both landings do. Exits 1 if any shape misses.

    python scripts/emulate_flash_bf16_cpu.py 1,128,128,2,64,1 1,77,77,1,256,1
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

import emulate_flash_bwd_cpu as bwd_emu  # noqa: E402
import emulate_moments_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_bf16.cu"
HEADERS = ("common.cuh",)
BF16_REL = 2.0 ** -7
LSE_TOL = 1e-4

HELPERS = r"""// ---- asynchronous copies, conversions and the tensor-core product (emulated)
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, bool ok) {
#ifdef EMU_EAGER
  std::memset(dst, 0, 16);
  if (ok) std::memcpy(dst, src, 16);
#else
  emu_open.push_back({reinterpret_cast<float*>(dst),
                      reinterpret_cast<const float*>(src), 16, ok ? 16 : 0});
#endif
}
__device__ __forceinline__ void commit() {
  emu_groups.push_back(std::move(emu_open));
  emu_open.clear();
}
template <int N>
__device__ __forceinline__ void wait_prior() {
  emu_land(N);
}
inline uint32_t emu_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return emu_bf16(lo) | emu_bf16(hi) << 16;
}
inline float emu_half(uint32_t reg, int half) {
  return __uint_as_float(((reg >> (16 * half)) & 0xffffu) << 16);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_warps[threadIdx.x >> 5];
  for (int i = 0; i < 4; ++i) W.a[lane][i] = a[i];
  W.b[lane][0] = b0;
  W.b[lane][1] = b1;
  W.bar->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    double s = d[i];
    for (int k = 0; k < 16; ++k) {
      const double av = emu_half(
          W.a[4 * (r & 7) + ((k & 7) >> 1)][(r >> 3) + 2 * (k >> 3)], k & 1);
      const double bv = emu_half(W.b[4 * n + ((k & 7) >> 1)][k >> 3], k & 1);
      s += av * bv;
    }
    out[i] = (float)s;
  }
  W.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
__device__ __forceinline__ float shfl_xor(float x, int m) {
  const int lane = threadIdx.x & 31;
  EmuWarp& W = emu_warps[threadIdx.x >> 5];
  W.c[lane][0] = x;
  W.bar->arrive_and_wait();
  const float r = W.c[lane ^ m][0];
  W.bar->arrive_and_wait();
  return r;
}
"""

NAN_FILL = ("std::fill(smem.begin(), smem.end(),\n"
            "                std::numeric_limits<float>::quiet_NaN());")


def rewrite(name: str) -> str:
    text = (build.CSRC / name).read_text()
    text = text.replace("#include <cuda_runtime.h>\n",
                        '#include "flash_emu.h"\n')
    if name == SOURCE:
        a = text.index("// ---- asynchronous copies, conversions and the "
                       "bf16 tensor-core product")
        b = text.index("// ------------------------------------------------"
                       "-----------------------------", a)
        text = text[:a] + HELPERS + text[b:]
    text = text.replace(
        "extern __shared__ float4 smem4[];",
        "float4* smem4 = reinterpret_cast<float4*>(emu_dyn_smem);")
    text = emu.LAUNCH.sub(bwd_emu._launch, text)
    if "asm" in re.sub(r"//.*", "", text):
        raise RuntimeError(f"{name}: inline assembly left after the rewrite")
    return text


def compile_library(out: Path, eager: bool) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    for name in HEADERS + (SOURCE,):
        (out / name).write_text(rewrite(name))
    if NAN_FILL not in emu.EMU_RT:
        raise RuntimeError("the harness's shared-memory fill moved")
    (out / "cuda_emu.h").write_text(emu.EMU_H)
    (out / "flash_emu.h").write_text(bwd_emu.EXTRA_H)
    (out / "emu_rt.cpp").write_text(emu.EMU_RT.replace(
        NAN_FILL, "std::memset(smem.data(), 0xff, smem.size() * 4);"))
    (out / "unit.cpp").write_text(f'#include "flash_emu.h"\n'
                                  f'#include "{SOURCE}"\n')
    lib = out / "flash_bf16_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "flash_emu.h",
                    *(["-DEMU_EAGER"] if eager else []), "-o", str(lib),
                    "unit.cpp", "emu_rt.cpp"], cwd=out, check=True)
    lib = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_bf16.argtypes = [P] * 5 + [I] * 5 + [F, I, P]
    lib.flash_attention_bwd_dq_bf16.argtypes = [P] * 7 + [I] * 5 + [F, I, P]
    lib.flash_attention_bwd_dkv_bf16.argtypes = [P] * 8 + [I] * 5 + [F, I, P]
    for fn in (lib.flash_attention_fwd_bf16, lib.flash_attention_bwd_dq_bf16,
               lib.flash_attention_bwd_dkv_bf16):
        fn.restype = I
    return lib


def _nan_like(x, dtype=None):
    return torch.full(x.shape, float("nan"), dtype=dtype or x.dtype)


def run(lib, q, k, v, do, causal):
    """(O, lse, dQ, dK, dV) of one call of each entry point; the backward
    from the plain forward's O and lse."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tail = (b, h, sq, sk, d, d ** -0.5, int(causal), None)
    o = _nan_like(q)
    lse = torch.full((b * h, sq), float("nan"))
    if lib.flash_attention_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), lse.data_ptr(), *tail):
        raise RuntimeError("forward refused")
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(ro, do)
    ins = [x.data_ptr() for x in (q, k, v, do, rlse, delta)]
    dq, dk, dv = _nan_like(q), _nan_like(k), _nan_like(v)
    if lib.flash_attention_bwd_dq_bf16(*ins, dq.data_ptr(), *tail):
        raise RuntimeError("dQ refused")
    if lib.flash_attention_bwd_dkv_bf16(*ins, dk.data_ptr(), dv.data_ptr(),
                                        *tail):
        raise RuntimeError("dK/dV refused")
    return o, lse, dq, dk, dv


def share(got, want, tol=None) -> float:
    """The largest |got - want| over the limit: 2^-7 max|want| + 2^-7
    |want| (bf16 outputs) or `tol` (atol = rtol)."""
    got, want = got.float(), want.float()
    if tol is None:
        lim = BF16_REL * want.abs().max() + BF16_REL * want.abs()
    else:
        lim = tol + tol * want.abs()
    return float(((got - want).abs() / lim).max())


def case(libs, b, sq, sk, h, d, causal):
    gen = torch.Generator().manual_seed(b + sq + 3 * sk + h + d)
    q, do = (torch.randn(b, sq, h, d, generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=gen).bfloat16()
            for _ in range(2))
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    want = (ro, rlse, *fa.flash_attention_bwd_reference(
        q, k, v, ro, rlse, do, causal=causal))
    got = run(libs["wait"], q, k, v, do, causal)
    again = run(libs["wait"], q, k, v, do, causal)
    eager = run(libs["eager"], q, k, v, do, causal)
    shares = [share(x, w, LSE_TOL if i == 1 else None)
              for i, (x, w) in enumerate(zip(got, want))]
    same = [all(torch.equal(x, y) for x, y in zip(got, o))
            for o in (again, eager)]
    print(f"B {b}, Sq {sq}, Sk {sk}, H {h}, D {d}, causal {causal}: largest "
          f"share of the limit O {shares[0]:.4f}, lse {shares[1]:.4f}, dQ "
          f"{shares[2]:.4f}, dK {shares[3]:.4f}, dV {shares[4]:.4f}; a second "
          f"call the same bits {same[0]}; copies landing at once the same "
          f"bits {same[1]}", flush=True)
    return max(shares) <= 1 and all(same)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="B,Sq,Sk,H,D,causal")
    args = ap.parse_args()
    torch.set_num_threads(1)
    libs = {name: compile_library(build.BUILD_DIR / f"flash_bf16_emu_{name}",
                                  name == "eager")
            for name in ("wait", "eager")}
    ok = []
    for shape in args.shapes:
        b, sq, sk, h, d, causal = map(int, shape.split(","))
        ok.append(case(libs, b, sq, sk, h, d, bool(causal)))
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
