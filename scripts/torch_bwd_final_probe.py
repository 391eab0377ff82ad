"""Where the time of the port's bwd_final kernels goes, on one GPU.

Builds the two launches of ``paddle_tpu_torch/csrc/bwd_final_tc.cuh``
(dx, which folds da1 once and writes it to a scratch; dW1, the split-K
product over N·S with the fixed-order sum of its splits) and ablations
of each, made by removing calls from copies of the source:

* dx: ``no copies`` (no W1 stages copied: the product and the epilogue
  over whatever the ring holds), ``no fold`` (the da1 tile neither
  built nor written), ``no mma`` (the fragment reads and the 3xTF32
  splits kept, each mma.sync replaced by an integer mix of its
  operands);
* dW1: ``no copies`` (the product over whatever the ring holds), ``no
  mma``.

Each launch is timed alone with CUDA events at ResNet-50's three
bottleneck-chain stages (batch 128), and each whole launch reports what
it moves and computes over its time: its bytes (each tensor it reads or
writes, once) in TB/s and its TF32 operations (three products, two
operations a multiply-add) in TFLOP/s. The no-copies builds report the
rate of their mma.sync alone. The ablations compute nothing useful; the
whole wrapper (``fused_block.bwd_final``) is checked against its plain
version first (dx within atol = rtol = 1e-4, dW1 within 1e-5 of the sum
of its terms' magnitudes), and both the kernel's dW1 and the plain
version's (float32, TF32 off) are held against the same product in
float64: which of the two carries the difference. Run from the
repository root on a machine with the CUDA toolkit:
``python scripts/torch_bwd_final_probe.py``.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402

STAGES = [(256, 64, 56), (512, 128, 28), (1024, 256, 14)]   # Cin, C, side
BATCH = 128
HEADER = "bwd_final_tc.cuh"
# dx runs conv1x1_tc.cuh's kernel: the ablations edit both headers
DX_NO_COPY = (("  copy_w(buffer(first), first,",
               "  if (false) copy_w(buffer(first), first,"),
              ("    if (s + 1 < stages) copy_w(", "    if (false) copy_w("))
DX_NO_FOLD = (("  fold<WIDE>(d, g1,", "  if (false) fold<WIDE>(d, g1,"),)
DW_NO_COPY = (("  copy_piece<WIDE>(buffer(0), jb,",
               "  if (false) copy_piece<WIDE>(buffer(0), jb,"),
              ("    if (s + 1 < stages)\n      copy_piece<WIDE>(",
               "    if (false)\n      copy_piece<WIDE>("))
# the two products' mma lines are alike: each build replaces both
NO_MMA = (
    ("          mma0(f[jj][i], as[i], bb[jj][0], bb[jj][1]);",
     "          for (int r = 0; r < 4; ++r) f[jj][i][r] = __uint_as_float("
     "as[i][r] ^ bb[jj][r & 1]);"),
    ("          mma(f[jj][i], ab[i], bs[jj][0], bs[jj][1]);",
     "          for (int r = 0; r < 4; ++r) f[jj][i][r] += __uint_as_float("
     "ab[i][r] ^ bs[jj][r & 1]);"),
    ("          mma(f[jj][i], ab[i], bb[jj][0], bb[jj][1]);",
     "          for (int r = 0; r < 4; ++r) f[jj][i][r] += __uint_as_float("
     "ab[i][r] ^ bb[jj][r & 1]);"))
# (launch, substitutions of the header)
VARIANTS = {
    "dx": ("dx", ()),
    "dx, no copies": ("dx", DX_NO_COPY),
    "dx, no fold": ("dx", DX_NO_FOLD),
    "dx, no mma": ("dx", NO_MMA),
    "dW1": ("dw1", ()),
    "dW1, no copies": ("dw1", DW_NO_COPY),
    "dW1, no mma": ("dw1", NO_MMA),
}
ENTRY = """
#include "{dir}/bwd_final_tc.cuh"
extern "C" int dx(const float* g3, const float* g1, const float* a1,
                  const float* p1, const float* q1, const float* r1,
                  const float* w1, float* dx, float* da1, int N, int Cin,
                  int C, int S, void* s) {{
  return bwd_final::input_gradient<true>(g3, g1, a1, p1, q1, r1, w1, dx, da1,
                                         N, Cin, C, S, Cin,
                                         static_cast<cudaStream_t>(s));
}}
extern "C" int dw1(const float* da1, const float* x, float* wpart,
                   float* dw1, int N, int Cin, int C, int S, int splits,
                   void* s) {{
  return bwd_final::weight_gradient<true>(da1, x, wpart, dw1, N, Cin, C, S,
                                          splits,
                                          static_cast<cudaStream_t>(s));
}}
"""
P, I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"dx": [P] * 9 + [I] * 4 + [P], "dw1": [P] * 4 + [I] * 5 + [P]}


def compile_variants(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (fn, subs)) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(exist_ok=True)
        found = set()
        for header in ("fused_block.cuh", "conv3x3_tc.cuh", "conv1x1_tc.cuh",
                       HEADER):
            text = (build.CSRC / header).read_text()
            if header in ("conv1x1_tc.cuh", HEADER):
                for old, new in subs:
                    if old in text:
                        found.add(old)
                        text = text.replace(old, new)
            (vdir / header).write_text(text)
        for old, _ in subs:
            if old not in found:
                raise RuntimeError(f"{name}: neither header has {old!r}")
        unit, lib = vdir / "probe.cu", vdir / "probe.so"
        unit.write_text(ENTRY.format(dir=vdir))
        jobs[name] = (fn, lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (fn, lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name in ("dx", "dW1"):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        f = getattr(ctypes.CDLL(str(lib)), fn)
        f.argtypes = ARGTYPES[fn]
        f.restype = ctypes.c_int
        fns[name] = (fn, f)
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    fns = compile_variants(build.BUILD_DIR / "bwd_final_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = build.sm_count(torch.device("cuda", 0))

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    for cin, c, side in STAGES:
        n, s = BATCH, side * side
        g3, x = randn(n, cin, s), randn(n, cin, s).abs()
        g1, a1 = randn(n, c, s), randn(n, c, s) + 0.3
        p1, q1, r1 = 1 + 0.2 * randn(c), 0.1 * randn(c), 0.1 * randn(c)
        w1 = randn(c, cin) * (2 / cin) ** 0.5
        args = (g3, g1, a1, x, p1, q1, r1, w1)
        got = fb.bwd_final(*args)
        want = fb.bwd_final_reference(*args)
        torch.cuda.synchronize()
        dx_share = float(((got[0] - want[0]).abs()
                          / (1e-4 + 1e-4 * want[0].abs())).max())
        col = lambda v: v.reshape(1, -1, 1)   # noqa: E731
        da1 = g1 * col(p1) + a1 * col(q1) + col(r1)

        def weight_grad(d, xs):
            return torch.einsum("ncs,nks->ck", d, xs)
        terms = weight_grad(da1.abs().double(), x.double())
        exact = weight_grad(da1.double(), x.double())

        def share(v, ref):
            return float(((v.double() - ref).abs() / (1e-5 * terms)).max())
        dw_share = share(got[1], want[1])
        assert dx_share <= 1 and dw_share <= 1, (dx_share, dw_share)
        f64 = (share(got[1], exact), share(want[1], exact))
        del got, want, terms, exact
        splits, _ = fb._bwd_final_grid(n, s, c, cin, sms)
        dx, da1_out = torch.empty_like(g3), torch.empty_like(g1)
        da1 = da1.contiguous()
        wpart = torch.empty(splits, c, cin, device="cuda")
        dw1 = torch.empty(c, cin, device="cuda")
        call_args = {
            "dx": (g3, g1, a1, p1, q1, r1, w1, dx, da1_out, n, cin, c, s),
            "dw1": (da1, x, wpart, dw1, n, cin, c, s, splits)}
        times = {}
        for name, (fn, f) in fns.items():
            ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in call_args[fn]]

            def call(f=f, ptrs=ptrs, name=name):
                err = f(*ptrs, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            times[name] = c3.cuda_ms(call)
        m = n * s
        tf32 = 3 * 2.0 * c * cin * m
        moved = {"dx": 4.0 * m * (3 * c + 2 * cin) + 4 * c * cin,
                 "dW1": 4.0 * m * (c + cin) + 4 * c * cin * (2 * splits + 1)}
        rates = "; ".join(
            f"{k} {moved[k] / times[k] / 1e9:.3f} TB/s of "
            f"{moved[k] / 1e9:.3f} GB, {tf32 / times[k] / 1e9:.1f} TFLOP/s "
            f"(no copies: {tf32 / times[k + ', no copies'] / 1e9:.1f})"
            for k in ("dx", "dW1"))
        print(f"bwd_final Cin {cin}, C {c}, {side}x{side}, batch {n}, "
              f"{splits} splits: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; {rates}; the wrapper's largest share of its limit: dx "
              f"{dx_share:.4f}, dW1 {dw_share:.4f}; dW1 against float64: "
              f"kernel {f64[0]:.4f}, plain {f64[1]:.4f} [{card}]",
              flush=True)
        del g3, x, g1, a1, da1, dx, da1_out, wpart
    return 0


if __name__ == "__main__":
    sys.exit(main())
