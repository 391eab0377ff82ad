"""Where the time of the port's bwd_mid kernels goes, on one GPU.

Builds the launches of ``paddle_tpu_torch/csrc/bwd_mid_tc.cuh`` (the fold
of da2, the input gradient on ``conv3x3_tc.cuh``'s kernel, the tap
gradients) and ablations of the two products, made by removing calls
from copies of the sources:

* input gradient: ``no copies`` (the product and the epilogue over
  whatever the ring holds), ``no product`` (the copies, the landing and
  the epilogue);
* tap gradients: ``no copies`` (product and normalization over whatever
  the ring holds), ``no normalization``, ``no product`` (the copies and
  the normalization), ``no mma`` (the fragment reads and the 3xTF32
  splits kept, each mma.sync replaced by an integer mix of its
  operands).

Each launch is timed alone with CUDA events at ResNet-50's three
bottleneck-chain stages (batch 128), and the tap gradients' no-copies
build reports its mma.sync rate: the TF32 operations of its tensor-core
instructions (three m16n8k8 products a k8 step, over the padded grid's
extra columns too) over its time. The ablations compute nothing useful;
the whole wrapper (``fused_block.bwd_mid``) is checked against its plain
version first (g1 within atol = rtol = 1e-4, dtaps within 1e-5 of the
sum of their terms' magnitudes), and both the kernel's dtaps and the
plain version's (float32, cuDNN's weight gradient with TF32 off) are
held against the same product in float64: which of the two carries the
difference. Run from the repository root on a machine with the CUDA
toolkit: ``python scripts/torch_bwd_mid_probe.py``.
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

STAGES = [(64, 56), (128, 28), (256, 14)]   # C, side
BATCH = 128
W_NO_COPY = (("  copy_stage(buffer(0), jb,",
              "  if (false) copy_stage(buffer(0), jb,"),
             ("    if (s + 1 < stages) copy_stage(",
              "    if (false) copy_stage("))
W_NO_NORM = (("    normalize(buffer(s), jb + s,",
              "    if (false) normalize(buffer(s), jb + s,"),)
W_NO_PRODUCT = (("    product(acc, buffer(s), wm,",
                 "    if (false) product(acc, buffer(s), wm,"),)
W_NO_MMA = (
    ("          conv3x3::mma0(f[j][i], as[i], bb[j][0], bb[j][1]);",
     "          for (int r = 0; r < 4; ++r) f[j][i][r] = __uint_as_float("
     "as[i][r] ^ bb[j][r & 1]);"),
    ("          conv3x3::mma(f[j][i], ab[i], bs[j][0], bs[j][1]);",
     "          for (int r = 0; r < 4; ++r) f[j][i][r] += __uint_as_float("
     "ab[i][r] ^ bs[j][r & 1]);"),
    ("          conv3x3::mma(f[j][i], ab[i], bb[j][0], bb[j][1]);",
     "          for (int r = 0; r < 4; ++r) f[j][i][r] += __uint_as_float("
     "ab[i][r] ^ bb[j][r & 1]);"))
# (launch, {header: substitutions})
VARIANTS = {
    "fold": ("fold", {}),
    "input gradient": ("input_gradient", {}),
    "input gradient, no copies": ("input_gradient", {
        "conv3x3_tc.cuh": c3.NO_COPY}),
    "input gradient, no product": ("input_gradient", {
        "conv3x3_tc.cuh": c3.NO_PRODUCT}),
    "tap gradients": ("tap_gradients", {}),
    "tap gradients, no copies": ("tap_gradients", {
        "bwd_mid_tc.cuh": W_NO_COPY}),
    "tap gradients, no normalization": ("tap_gradients", {
        "bwd_mid_tc.cuh": W_NO_NORM}),
    "tap gradients, no product": ("tap_gradients", {
        "bwd_mid_tc.cuh": W_NO_PRODUCT}),
    "tap gradients, no mma": ("tap_gradients", {
        "bwd_mid_tc.cuh": W_NO_MMA}),
}
ENTRY = """
#include "{dir}/bwd_mid_tc.cuh"
extern "C" int fold(const float* g2, const float* a2, const float* p2,
                    const float* q2, const float* r2, float* da2, int N, int C,
                    int S, void* s) {{
  return bwd_mid::fold(g2, a2, p2, q2, r2, da2, N, C, S,
                       static_cast<cudaStream_t>(s));
}}
extern "C" int input_gradient(const float* da2, const float* taps_t,
                              const float* a1, const float* sc1,
                              const float* sh1, const float* inv1,
                              const float* m1, float* g1, float* part,
                              float* stats, int N, int C, int H, int W, int T,
                              void* s) {{
  return bwd_mid::input_gradient(da2, taps_t, a1, sc1, sh1, inv1, m1, g1,
                                 part, stats, N, C, H, W, T,
                                 static_cast<cudaStream_t>(s));
}}
extern "C" int tap_gradients(const float* da2, const float* a1,
                             const float* sc1, const float* sh1, float* wpart,
                             float* dtaps, int N, int C, int H, int W,
                             int splits, int per, void* s) {{
  return bwd_mid::tap_gradients(da2, a1, sc1, sh1, wpart, dtaps, N, C, H, W,
                                splits, per, static_cast<cudaStream_t>(s));
}}
"""
P, I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"fold": [P] * 6 + [I] * 3 + [P],
            "input_gradient": [P] * 10 + [I] * 5 + [P],
            "tap_gradients": [P] * 6 + [I] * 6 + [P]}


def compile_variants(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (fn, subs)) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(exist_ok=True)
        for header in ("fused_block.cuh", "conv3x3_tc.cuh", "bwd_mid_tc.cuh"):
            text = (build.CSRC / header).read_text()
            for old, new in subs.get(header, ()):
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {header} no longer has "
                                       f"{old!r}")
                text = text.replace(old, new)
            (vdir / header).write_text(text)
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
        if name in ("input gradient", "tap gradients"):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        f = getattr(ctypes.CDLL(str(lib)), fn)
        f.argtypes = ARGTYPES[fn]
        f.restype = ctypes.c_int
        fns[name] = (fn, f)
    return fns


def tap_mma_flops(n: int, c: int, side: int) -> float:
    """TF32 operations of the tap gradients' mma.sync instructions: 9
    taps of the (64 · tiles)² tile rows and columns, over n images' 32-
    position pieces, three products, two operations a multiply-add."""
    pieces = -(-side * (side + 2) // 32)
    return 3 * 2.0 * 9 * (64 * -(-c // 64)) ** 2 * n * pieces * 32


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    fns = compile_variants(build.BUILD_DIR / "bwd_mid_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = build.sm_count(torch.device("cuda", 0))

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    for c, side in STAGES:
        n, s = BATCH, side * side
        g2, a2, a1 = randn(n, c, s), randn(n, c, s), randn(n, c, s) + 0.3
        sc1 = torch.rand(c, device="cuda", generator=gen) + 0.5
        sh1, inv1 = 0.3 * randn(c) + 0.2, randn(c).abs() + 0.5
        p2, q2, r2, m1 = randn(c), 0.1 * randn(c), 0.1 * randn(c), randn(c)
        taps = randn(9, c, c) * (2 / (9 * c)) ** 0.5
        args = (g2, a2, a1, sc1, sh1, p2, q2, r2, inv1, m1, taps, side)
        got = fb.bwd_mid(*args)
        want = fb.bwd_mid_reference(*args)
        torch.cuda.synchronize()
        g1_share = float(((got[0] - want[0]).abs()
                          / (1e-4 + 1e-4 * want[0].abs())).max())
        col = lambda v: v.reshape(1, -1, 1)   # noqa: E731
        da2 = (g2 * col(p2) + a2 * col(q2) + col(r2)).view(n, c, side, side)
        h1 = fb._norm_relu(a1, sc1, sh1).view(n, c, side, side)

        def tap_grads(x, d):
            return torch.nn.grad.conv2d_weight(x, (c, c, 3, 3), d, padding=1
                                               ).permute(2, 3, 0, 1).reshape(
                                                   9, c, c)
        terms = tap_grads(h1.double(), da2.abs().double())
        exact = tap_grads(h1.double(), da2.double())

        def share(x, ref):
            return float(((x.double() - ref).abs() / (1e-5 * terms)).max())
        tap_share = share(got[1], want[1])
        assert g1_share <= 1 and tap_share <= 1, (g1_share, tap_share)
        f64 = (share(got[1], exact), share(want[1], exact))
        del got, want, h1, terms, exact
        da2 = da2.reshape(n, c, s).contiguous()
        taps_t = taps.flip(0).transpose(1, 2).contiguous()
        _, t, _ = fb._conv3x3_grid(n, side, side)
        splits, per = fb._bwd_mid_grid(n, side, side, c, sms)
        out_da2, g1 = torch.empty_like(g2), torch.empty_like(g2)
        part = torch.empty(2, c, t, device="cuda")
        stats = torch.empty(2, c, device="cuda")
        wpart = torch.empty(splits, 9, c, c, device="cuda")
        dtaps = torch.empty(9, c, c, device="cuda")
        call_args = {
            "fold": (g2, a2, p2, q2, r2, out_da2, n, c, s),
            "input_gradient": (da2, taps_t, a1, sc1, sh1, inv1, m1, g1, part,
                               stats, n, c, side, side, t),
            "tap_gradients": (da2, a1, sc1, sh1, wpart, dtaps, n, c, side,
                              side, splits, per)}
        times = {}
        for name, (fn, f) in fns.items():
            ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in call_args[fn]]

            def call(f=f, ptrs=ptrs, name=name):
                err = f(*ptrs, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            times[name] = c3.cuda_ms(call)
        rate = tap_mma_flops(n, c, side) / times[
            "tap gradients, no copies"] / 1e9
        print(f"bwd_mid C {c}, {side}x{side}, batch {n}, {splits} splits of "
              f"{per} pieces: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; tap gradients' no-copies mma.sync TF32 rate {rate:.1f} "
              f"TFLOP/s; the wrapper's largest share of its limit: g1 "
              f"{g1_share:.4f}, dtaps {tap_share:.4f}; dtaps against "
              f"float64: kernel {f64[0]:.4f}, plain {f64[1]:.4f} [{card}]",
              flush=True)
        del g2, a2, a1, da2, out_da2, g1, wpart
    return 0


if __name__ == "__main__":
    sys.exit(main())
