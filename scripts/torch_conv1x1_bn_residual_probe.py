"""Where the time of the port's conv1x1_bn_residual kernel goes, on one
GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/conv1x1_tc.cuh`` (h2 built
once a block into a shared-memory tile, W3ᵀ by ``cp.async`` through a
ring, the product in 3xTF32 ``mma.sync``, bn3's affine, the residual and
the ReLU in the epilogue) and variants of it, made by editing copies of
the header:

* ``no copies``: no W3ᵀ stage copied (the product over whatever the ring
  holds);
* ``no tile``: the h2 tile not built (the product over whatever shared
  memory holds): what reading and normalizing a2 costs;
* ``no residual``: the epilogue reads no residual (adds 0);
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;
* ``late residual``: a chunk's residual read in its epilogue, after its
  products, instead of into registers before its first W3ᵀ stage (also
  timed in turns with the kernel, ten rounds);
* ``no split``: the kernel itself with Cout's chunks not shared out over
  a second grid dimension, where ``_res_grid`` splits them;

and, with ``--parent DIR`` (DIR holds another tree's
``paddle_tpu_torch/csrc``, e.g. the parent unpacked by ``git
archive``), that tree's ``fused_block.cu`` entry point, timed in turns
with this tree's kernel (parent, kernel, kernel, parent). A parent whose
entry point takes W3 itself (the float32 SIMT kernel's) is called so.

Each runs at ResNet-50's three bottleneck-chain stages (batch 128) on
the inputs the chain makes there (the plain versions of the kernels
before it), timed with CUDA events; the kernel reports its bytes (each
tensor read once, out written once) in TB/s and its TF32 operations
(three products, two operations a multiply-add) in TFLOP/s. The
variants compute nothing useful; the wrapper (``fused_block.
conv1x1_bn_residual``) is checked against its plain version first
(atol = rtol = 1e-5), and both the kernel's out and the plain version's
(float32, TF32 off) are held against the same function computed in
float64: which of the two carries the difference. Run from the
repository root on a machine with the CUDA toolkit:
``python scripts/torch_conv1x1_bn_residual_probe.py [--parent DIR]``.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402
import torch_chain_ab as ab  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402

HEADER = "conv1x1_tc.cuh"
NO_COPY = (("  copy_w(buffer(first), first,",
            "  if (false) copy_w(buffer(first), first,"),
           ("    if (s + 1 < stages) copy_w(", "    if (false) copy_w("))
NO_TILE = (("  Use::template tile<WIDE>(",
            "  if (false) Use::template tile<WIDE>("),)
NO_RESIDUAL = (("""              e.r[i][hr][j] = __ldg(
                  reinterpret_cast<const float2*>(x + off[j][0] + ci * S));""",
                "              e.r[i][hr][j] = make_float2(0.f, 0.f);"),)
LATE_RESIDUAL = (
    ("      Use::template fetch<WIDE>(early, off, add,",
     "      if (false) Use::template fetch<WIDE>(early, off, add,"),
    ("      const float* __restrict__, const float* __restrict__ sc3,",
     "      const float* __restrict__ x, const float* __restrict__ sc3,"),
    ("          const float2 r = e.r[i][hr][j];",
     "          const float2 r = off[j][0] < 0 ? make_float2(0.f, 0.f) : "
     "__ldg(reinterpret_cast<const float2*>(x + off[j][0] + ci * S));"))
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
VARIANTS = {
    "kernel": (),
    "no copies": NO_COPY,
    "no tile": NO_TILE,
    "no residual": NO_RESIDUAL,
    "no mma": NO_MMA,
    "late residual": LATE_RESIDUAL,
}
ENTRY = """
#include "{dir}/conv1x1_tc.cuh"
extern "C" int res(const float* a2, const float* x, const float* wt,
                   const float* sc2, const float* sh2, const float* sc3,
                   const float* sh3, float* out, int N, int C, int Cout,
                   int S, int ldw, int splits, void* s) {{
  return conv1x1::bn_residual<true>(a2, x, wt, sc2, sh2, sc3, sh3, out, N,
                                    C, Cout, S, ldw, splits,
                                    static_cast<cudaStream_t>(s));
}}
"""
P, I = ctypes.c_void_p, ctypes.c_int


ROUNDS = 10


def in_turns(first, second, rounds):
    """second's time over first's, timed in turns (first, second, second,
    first), once a round."""
    ratios = []
    for _ in range(rounds):
        a0, b0, b1, a1 = (c3.cuda_ms(f) for f in (first, second, second,
                                                   first))
        ratios.append((b0 + b1) / (a0 + a1))
    return ratios


def compile_variants(out_dir: Path, parent) -> dict:
    """{name: entry point} of every variant (and of the parent's
    fused_block.cu, as "parent"), built in parallel; prints the kernel's
    registers and spills."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(exist_ok=True)
        for header in ("fused_block.cuh", "conv3x3_tc.cuh", HEADER):
            text = (build.CSRC / header).read_text()
            if header == HEADER:
                for old, new in subs:
                    if old not in text:
                        raise RuntimeError(f"{name}: {header} no longer has "
                                           f"{old!r}")
                    text = text.replace(old, new)
            (vdir / header).write_text(text)
        unit, lib = vdir / "probe.cu", vdir / "probe.so"
        unit.write_text(ENTRY.format(dir=vdir))
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    if parent is not None:
        lib = out_dir / "parent.so"
        jobs["parent"] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(parent / "paddle_tpu_torch" / "csrc" / "fused_block.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "kernel":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        fns[name] = ctypes.CDLL(str(lib))
    return fns


def stage_inputs(n, cin, c, h, gen):
    """(a2, x, sc2, sh2, w3, sc3, sh3) as the chain makes them at a stage:
    chip_smoke's chain case through the plain versions of the kernels
    before, bn3's affine from the plain moments."""
    d = chip_smoke.chain_case(torch, n, cin, c, h, gen)
    m = n * h * h
    x, w1, taps, w3 = d["x"], d["w1"], d["taps"], d["w3"]
    a1, s1, q1 = fb.conv1x1_stats_reference(x, w1)
    _, _, sc1, sh1 = fb._bn_fold(s1, q1, m, d["gam"][0], d["bet"][0])
    a2, s2, q2 = fb.conv3x3_norm_stats_reference(a1, taps, sc1, sh1, h)
    del a1
    _, _, sc2, sh2 = fb._bn_fold(s2, q2, m, d["gam"][1], d["bet"][1])
    sum_h, m2h = fb.norm_relu_moments_reference(a2, sc2, sh2)
    _, _, sc3, sh3 = fb._bn3_fold(w3, sum_h, m2h, m, d["gam"][2],
                                  d["bet"][2])
    return a2, x, sc2, sh2, w3, sc3, sh3


def float64_out(a2, x, sc2, sh2, w3, sc3, sh3):
    col = lambda v: v.double().reshape(1, -1, 1)   # noqa: E731
    h2 = torch.clamp_min(a2.double() * col(sc2) + col(sh2), 0.0)
    a3 = torch.matmul(w3.double(), h2)
    return torch.clamp_min(a3 * col(sc3) + col(sh3) + x.double(), 0.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    parent = args.parent.resolve() if args.parent else None
    libs = compile_variants(build.BUILD_DIR / "conv1x1_probe", parent)
    fns = {}
    for name, lib in libs.items():
        if name == "parent":
            continue
        f = lib.res
        f.argtypes = [P] * 8 + [I] * 6 + [P]
        f.restype = ctypes.c_int
        fns[name] = f
    stream = torch.cuda.current_stream().cuda_stream
    sms = build.sm_count(torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(15)
    n = chip_smoke.RESNET["batch"]
    for cin, c, h in chip_smoke.CHAIN_SHAPES:
        s = h * h
        inputs = stage_inputs(n, cin, c, h, gen)
        a2, x, sc2, sh2, w3, sc3, sh3 = inputs
        got = fb.conv1x1_bn_residual(*inputs)
        want = fb.conv1x1_bn_residual_reference(*inputs)
        torch.cuda.synchronize()
        limit = chip_smoke.limit_share(torch, got, want)
        assert limit <= 1, limit
        exact = float64_out(*inputs)

        def f64_share(v):
            return float(((v.double() - exact).abs()
                          / (1e-5 + 1e-5 * exact.abs())).max())
        f64 = (f64_share(got), f64_share(want))
        del got, want, exact
        _, splits = fb._res_grid(n, s, cin, sms)
        ldw = -(-cin // 4) * 4
        wt = torch.nn.functional.pad(w3.t(), (0, ldw - cin)).contiguous()
        out = torch.empty_like(x)
        ptrs = [t.data_ptr() for t in (a2, x, wt, sc2, sh2, sc3, sh3, out)]
        calls = {}
        for name, f in fns.items():
            def call(f=f, name=name, k=splits):
                err = f(*ptrs, n, c, cin, s, ldw, k, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            calls[name] = call
        kernel = calls["kernel"]
        calls["no split"] = lambda: kernel(k=1)
        times = {k: c3.cuda_ms(v) for k, v in calls.items()}
        late = in_turns(calls["kernel"], calls["late residual"], ROUNDS)
        turns = (f"; late residual in turns, {ROUNDS} rounds: "
                 f"{sorted(late)[ROUNDS // 2]:.4f}x the kernel (median; "
                 f"{min(late):.4f}-{max(late):.4f})")
        if "parent" in libs:
            if ab.parent_takes_w3(parent):
                pf = libs["parent"].fused_block_conv1x1_bn_residual_f32
                pf.argtypes = [P] * 8 + [I] * 4 + [P]
                pargs = [t.data_ptr() for t in (a2, x, w3, sc2, sh2, sc3,
                                                sh3, out)] + [n, c, cin, s]
            else:
                pf = libs["parent"].fused_block_conv1x1_bn_residual_f32
                pf.argtypes = [P] * 8 + [I] * 7 + [P]
                pargs = ptrs + [n, c, cin, s, ldw, splits, 1]
            pf.restype = ctypes.c_int
            both = {"parent": lambda: pf(*pargs, stream),
                    "kernel": calls["kernel"]}
            seq = [(w, c3.cuda_ms(both[w])) for w in
                   ("parent", "kernel", "kernel", "parent")]
            ratio = (seq[1][1] + seq[2][1]) / (seq[0][1] + seq[3][1])
            turns += ("; in turns: " + ", ".join(f"{w} {t:.4f}" for w, t in seq)
                     + f" ({ratio:.4f}x)")
        m = n * s
        tf32 = 3 * 2.0 * cin * c * m
        moved = 4.0 * (m * c + 2 * m * cin + cin * c + 2 * c + 2 * cin)
        t = times["kernel"]
        print(f"conv1x1_bn_residual Cin {cin}, C {c}, {h}x{h}, batch {n}, "
              f"{splits} split(s): " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; kernel {moved / t / 1e9:.3f} TB/s of {moved / 1e9:.3f} "
              f"GB, {tf32 / t / 1e9:.1f} TFLOP/s of TF32 (no copies: "
              f"{tf32 / times['no copies'] / 1e9:.1f}){turns}; the "
              f"wrapper's largest share of the 1e-5 limit {limit:.4f}; "
              f"against float64: kernel {f64[0]:.4f}, plain {f64[1]:.4f} "
              f"[{card}]", flush=True)
        del inputs, a2, x, w3, wt, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
