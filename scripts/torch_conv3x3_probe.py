"""Where the time of the port's conv3x3_norm_stats kernel goes, on one GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/conv3x3_tc.cuh`` and three
ablations of it, made by removing calls from a copy of the source:

* ``product only``: no copies and no normalization (the 3xTF32 product of
  whatever the ring holds);
* ``staging only``: the copies of the halo and of the taps, no
  normalization and no product;
* ``staging + normalization``: no product;
* ``product, no splits``: product only, each operand passed to the
  tensor cores as it is (big = x, small = x with its last bit flipped)
  instead of split;
* ``product, no fresh fragments``: product only, the three products
  accumulated straight into the accumulators (the precision fault the
  fresh fragments repair), without their float32 adds.

Each is timed with CUDA events at ResNet-50's three bottleneck-chain
stages (batch 128), beside the whole kernel, and the product-only build's
mma.sync rate is reported: the TF32 operations its tensor-core
instructions execute (three m16n8k8 products a k8 step, over the padded
grid's discarded columns and a tile's empty rows too) over its time.
Beside it, the rate of mma.sync m16n8k8 TF32 alone: one block an SM of 8
or 16 warps, each issuing 8 independent chains of the instruction on
registers, nothing else. The ablations compute nothing useful; only the
whole kernel is checked against the plain version (atol = rtol = 1e-5).
Run from the repository root on a machine with the CUDA toolkit:
``python scripts/torch_conv3x3_probe.py``.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402

STAGES = [(64, 56), (128, 28), (256, 14)]   # C (= Cin = Cout), side
BATCH = 128
COPY_FIRST = "  copy_stage(buffer(0),"
COPY_NEXT = "    if (s + 1 < stages)\n      copy_stage("
NORMALIZE = "    normalize(buffer(s),"
PRODUCT = "    product(acc, buffer(s),"
NO_COPY = ((COPY_FIRST, "  if (false) copy_stage(buffer(0),"),
           (COPY_NEXT, "    if (false)\n      copy_stage("))
NO_NORMALIZE = ((NORMALIZE, "    if (false) normalize(buffer(s),"),)
NO_PRODUCT = ((PRODUCT, "    if (false) product(acc, buffer(s),"),)
NO_SPLIT = (("""  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));""",
             """  big = __float_as_uint(x);
  small = big ^ 1u;"""),)
NO_FRESH = (("          mma0(f[jj][i], as[i], bb[jj][0], bb[jj][1]);",
             "          mma(acc[i][j0 + jj], as[i], bb[jj][0], bb[jj][1]);"),
            ("          mma(f[jj][i], ab[i], bs[jj][0], bs[jj][1]);",
             "          mma(acc[i][j0 + jj], ab[i], bs[jj][0], bs[jj][1]);"),
            ("""          mma(f[jj][i], ab[i], bb[jj][0], bb[jj][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j0 + jj][r] += f[jj][i][r];""",
             "          mma(acc[i][j0 + jj], ab[i], bb[jj][0], bb[jj][1]);"))
VARIANTS = {"whole kernel": (),
            "product only": NO_COPY + NO_NORMALIZE,
            "staging only": NO_NORMALIZE + NO_PRODUCT,
            "staging + normalization": NO_PRODUCT,
            "product, no splits": NO_COPY + NO_NORMALIZE + NO_SPLIT,
            "product, no fresh fragments": NO_COPY + NO_NORMALIZE + NO_FRESH}
ENTRY = """
#include "{header}"
extern "C" int probe(const float* a1, const float* taps, const float* scale,
                     const float* shift, float* y, float* part, float* stats,
                     int N, int Cin, int Cout, int H, int W, int T,
                     void* stream) {{
  return conv3x3::launch(a1, taps, conv3x3::NormRelu{{scale, shift}},
                         conv3x3::Stats{{y}}, part, stats, N, Cin, Cout, H, W,
                         T, static_cast<cudaStream_t>(stream));
}}
"""
PEAK = """
#include <cstdint>
#include <cuda_runtime.h>
__global__ void peak(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4];
  for (int r = 0; r < 4; ++r) a[r] = __float_as_uint(1.f + threadIdx.x + r);
  const uint32_t b0 = __float_as_uint(0.5f + threadIdx.x), b1 = b0 ^ 4096u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(float* out, int blocks, int threads, int iters) {
  peak<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_peak(out_dir: Path, sms: int) -> dict:
    """{warps an SM: TF32 TFLOP/s} of mma.sync m16n8k8 alone."""
    unit, lib = out_dir / "peak.cu", out_dir / "peak.so"
    unit.write_text(PEAK)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(unit)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    out = torch.empty(sms * 512, device="cuda")
    rates = {}
    for threads in (256, 512):
        def call(threads=threads):
            if fn(out.data_ptr(), sms, threads, 4096):
                raise RuntimeError("peak: launch failed")
        rates[threads // 32] = (sms * threads // 32 * 8 * 4096 * 2048
                                / cuda_ms(call, 5) / 1e9)
    return rates


def compile_variants(out_dir: Path) -> dict:
    source = (build.CSRC / "conv3x3_tc.cuh").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = source.replace('#include "fused_block.cuh"',
                              f'#include "{build.CSRC / "fused_block.cuh"}"')
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        header, unit = out_dir / f"v{i}.cuh", out_dir / f"v{i}.cu"
        header.write_text(text)
        unit.write_text(ENTRY.format(header=header))
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        fn = ctypes.CDLL(str(lib)).probe
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mma_flops(n: int, c: int, side: int) -> float:
    """TF32 operations of the kernel's mma.sync instructions: per block
    (64 rows by 224 positions), per 8-channel stage, 9 taps x 3 products
    of 64 x 224 x 8, two operations a multiply-add."""
    _, t, _ = fb._conv3x3_grid(n, side, side)
    return -(-c // 64) * t * (c // 8) * 9 * 3 * 2.0 * 64 * 224 * 8


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    fns = compile_variants(build.BUILD_DIR / "conv3x3_probe")
    peak = mma_peak(build.BUILD_DIR / "conv3x3_probe",
                    build.sm_count(torch.device("cuda", 0)))
    print("mma.sync m16n8k8 TF32 alone, 8 independent chains a warp: "
          + "; ".join(f"{w} warps an SM {r:.1f} TFLOP/s"
                      for w, r in peak.items()) + f" [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for c, side in STAGES:
        n, s = BATCH, side * side
        a1 = torch.randn(n, c, s, device="cuda", generator=gen) + 0.3
        taps = torch.randn(9, c, c, device="cuda", generator=gen) * (
            2 / (9 * c)) ** 0.5
        sc = torch.rand(c, device="cuda", generator=gen) + 0.5
        sh = 0.3 * torch.randn(c, device="cuda", generator=gen) + 0.2
        _, t, ring = fb._conv3x3_grid(n, side, side)
        y = torch.empty(n, c, s, device="cuda")
        part = torch.empty(2, c, t, device="cuda")
        stats = torch.empty(2, c, device="cuda")
        times = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(a1.data_ptr(), taps.data_ptr(), sc.data_ptr(),
                         sh.data_ptr(), y.data_ptr(), part.data_ptr(),
                         stats.data_ptr(), n, c, c, side, side, t, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            if name == "whole kernel":
                call()
                want = fb.conv3x3_norm_stats_reference(a1, taps, sc, sh, side)
                torch.cuda.synchronize()
                limit = 1e-5 + 1e-5 * want[0].abs()
                share = float(((y - want[0]).abs() / limit).max())
                assert share <= 1, f"the kernel disagrees: share {share}"
                del want, limit
            times[name] = cuda_ms(call)
        rate = mma_flops(n, c, side) / times["product only"] / 1e9
        print(f"conv3x3_norm_stats C {c}, {side}x{side}, batch {n}, {t} "
              f"column tiles, ring {ring} B: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; product-only mma.sync TF32 rate {rate:.1f} TFLOP/s; "
              f"whole kernel's largest share of its limit {share:.4f} "
              f"[{card}]", flush=True)
        del a1, y, part
    return 0


if __name__ == "__main__":
    sys.exit(main())
