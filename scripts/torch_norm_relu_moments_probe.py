"""Where the time of the port's norm_relu_moments kernel goes, on one GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/moments_tc.cuh`` (a split-K
Gram product of h = relu(a2·scale + shift) over the upper triangle, a2
by ``cp.async`` through a ring, each value normalized as it lands, the
product in 3xTF32 ``mma.sync``, the splits added in order with M2's
lower triangle mirrored) and variants of it, made by editing copies of
the header:

* ``no copies``: no stage copied (the product over whatever the ring
  holds);
* ``no landing``: the landed a2 not normalized in place: what building h
  once a value costs;
* ``no barrier``: no barrier between a stage's landing and its products
  (the products read stages that other threads may still be writing);
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;
* ``one product``: big·big alone, plain TF32, in place of the three
  products (the small halves then go unused);
* ``no splits``: each value's TF32 split left out, its bits taken as
  both halves;
* ``eight chains``: the fresh fragments of all four n8 tiles of a k8
  step in flight at once, not two at a time;
* ``splits x2``: the kernel itself with twice ``_moments_grid``'s splits
  (more, shorter blocks against more partials to add);

and, with ``--parent DIR`` (DIR holds another tree's
``paddle_tpu_torch/csrc``, e.g. the parent unpacked by ``git archive``),
that tree's ``fused_block.cu`` entry point, timed in turns with this
tree's kernel (parent, kernel, kernel, parent). A parent whose entry
point takes a column chunk (the float32 SIMT kernel's) is called with
that kernel's grid.

Each runs at ResNet-50's three bottleneck-chain stages (batch 128) on the
inputs the chain makes there (the plain versions of the kernels before),
timed with CUDA events over the whole call (the product and its pass
over the splits); the kernel reports its bytes (a2 read once, the
outputs written once) in TB/s and its TF32 operations (three products
of the C (C + 1) / 2 entries of M2's upper triangle a position, two
operations a multiply-add) in TFLOP/s. The variants compute nothing
useful; the wrapper (``fused_block.norm_relu_moments``) is checked
against its plain version first (Σh and M2 within rtol 1e-5 of their
terms, h >= 0), and both the kernel's Σh and M2 and the plain version's
(float32, TF32 off) are held against the same sums computed in float64:
which of the two carries the difference. Run from the repository root on
a machine with the CUDA toolkit:
``python scripts/torch_norm_relu_moments_probe.py [--parent DIR]``.
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

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402
import torch_chain_ab as ab  # noqa: E402
import torch_conv1x1_bn_residual_probe as res  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402

HEADER = "moments_tc.cuh"
NO_COPY = (("      copy_piece<WIDE>(buffer(s), jb + s, a2, tl, C, S, NS);",
            "      if (false) copy_piece<WIDE>(buffer(s), jb + s, a2, tl, C, "
            "S, NS);"),
           ("      copy_piece<WIDE>(buffer(s + kRing - 1),",
            "      if (false) copy_piece<WIDE>(buffer(s + kRing - 1),"))
NO_LAND = (("    land<WIDE>(buffer(s), jb + s,",
            "    if (false) land<WIDE>(buffer(s), jb + s,"),)
NO_BARRIER = (("tl, C, NS);\n    __syncthreads();", "tl, C, NS);\n"),)
ONE_PRODUCT = tuple(zip((old for old, _ in res.NO_MMA),
                        ("          ;", "          ;",
                         "          mma0(f[jj][i], ab[i], bb[jj][0], "
                         "bb[jj][1]);")))
NO_SPLITS = (("using conv3x3::split;",
              "__device__ __forceinline__ void split(float x, uint32_t& b, "
              "uint32_t& s) { b = s = __float_as_uint(x); }"),)
EIGHT_CHAINS = (
    ("uint32_t bb[2][2], bs[2][2];", "uint32_t bb[4][2], bs[4][2];"),
    ("for (int jj = 0; jj < 2; ++jj) {\n        const int j = j0 + jj;",
     "for (int jj = 0; jj < 4; ++jj) {\n        const int j = j0 + jj;"),
    ("float f[2][2][4];", "float f[4][2][4];"),
    ("for (int j0 = 0; j0 < 4; j0 += 2) {",
     "for (int j0 = 0; j0 < 4; j0 += 4) {"),
    ("      for (int jj = 0; jj < 2; ++jj)\n#pragma unroll\n"
     "        for (int i = 0; i < kI; ++i)",
     "      for (int jj = 0; jj < 4; ++jj)\n#pragma unroll\n"
     "        for (int i = 0; i < 2; ++i) if (!(DIAG && i == 1 && jj < 2))"))
VARIANTS = {
    "kernel": (),
    "no copies": NO_COPY,
    "no landing": NO_LAND,
    "no barrier": NO_BARRIER,
    "no mma": res.NO_MMA,   # the same three mma lines as conv1x1_tc.cuh's
    "one product": ONE_PRODUCT,
    "no splits": NO_SPLITS,
    "eight chains": EIGHT_CHAINS,
}
ENTRY = """
#include "{dir}/moments_tc.cuh"
extern "C" int mom(const float* a2, const float* scale, const float* shift,
                   float* part, float* out, int N, int C, int S, int splits,
                   int wide, void* s) {{
  const cudaStream_t st = static_cast<cudaStream_t>(s);
  return wide ? moments::launch<true>(a2, scale, shift, part, out, N, C, S,
                                      splits, st)
              : moments::launch<false>(a2, scale, shift, part, out, N, C,
                                       S, splits, st);
}}
"""
P, I = ctypes.c_void_p, ctypes.c_int


def compile_variants(out_dir: Path, parent) -> dict:
    """{name: library} of every variant (and of the parent's
    fused_block.cu, as "parent"), built in parallel; prints each build's
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
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry function" in line and "moments_tc" in line:
                wide = "ILb1E" in line
                notes = [f.split(":")[-1].strip() for f in lines[k + 1:k + 4]
                         if "registers" in f or "spill" in f]
                print(f"  {name}, {'16' if wide else '4'}-byte copies: "
                      + "; ".join(notes))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def stage_inputs(n, cin, c, h, gen):
    """(a2, sc2, sh2) as the chain makes them at a stage: chip_smoke's
    chain case through the plain versions of the kernels before."""
    d = chip_smoke.chain_case(torch, n, cin, c, h, gen)
    m = n * h * h
    a1, s1, q1 = fb.conv1x1_stats_reference(d["x"], d["w1"])
    _, _, sc1, sh1 = fb._bn_fold(s1, q1, m, d["gam"][0], d["bet"][0])
    a2, s2, q2 = fb.conv3x3_norm_stats_reference(a1, d["taps"], sc1, sh1, h)
    _, _, sc2, sh2 = fb._bn_fold(s2, q2, m, d["gam"][1], d["bet"][1])
    return a2, sc2, sh2


def shares(sum_h, m2, exact_s, exact_m):
    """The largest |v - exact| / (1e-5·exact) of Σh and of M2."""
    def one(v, e):
        return float(((v.double() - e).abs()
                      / (1e-5 * e).clamp_min(1e-300)).max())
    return one(sum_h, exact_s), one(m2, exact_m)


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
    libs = compile_variants(build.BUILD_DIR / "moments_probe", parent)
    fns = {}
    for name, lib in libs.items():
        if name == "parent":
            continue
        f = lib.mom
        f.argtypes = [P] * 5 + [I] * 5 + [P]
        f.restype = ctypes.c_int
        fns[name] = f
    stream = torch.cuda.current_stream().cuda_stream
    sms = build.sm_count(torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(16)
    n = chip_smoke.RESNET["batch"]
    for cin, c, h in chip_smoke.CHAIN_SHAPES:
        s, m = h * h, n * h * h
        a2, sc2, sh2 = stage_inputs(n, cin, c, h, gen)
        got = fb.norm_relu_moments(a2, sc2, sh2)
        want = fb.norm_relu_moments_reference(a2, sc2, sh2)
        torch.cuda.synchronize()
        limit = max(chip_smoke.check_sums(torch, "norm_relu_moments", g, w,
                                          w)[1] for g, w in zip(got, want))
        symmetric = torch.equal(got[1], got[1].T)
        hd = torch.clamp_min(a2.double() * sc2.double().view(1, -1, 1)
                             + sh2.double().view(1, -1, 1), 0.0)
        hd = hd.permute(1, 0, 2).reshape(c, m)
        exact = (hd.sum(dim=1), hd @ hd.T)
        del hd
        f64 = (shares(*got, *exact), shares(*want, *exact))
        del got, want, exact
        _, splits, _ = fb._moments_grid(n, s, c, sms)
        wide = int(s % 4 == 0 and a2.data_ptr() % 16 == 0)
        part = torch.empty(2 * splits, c, c + 1, device="cuda")
        out = torch.empty(c, c + 1, device="cuda")
        ptrs = [t.data_ptr() for t in (a2, sc2, sh2, part, out)]
        calls = {}
        for name, f in fns.items():
            def call(f=f, name=name, k=splits):
                err = f(*ptrs, n, c, s, k, wide, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            calls[name] = call
        kernel = calls["kernel"]
        calls["splits x2"] = lambda: kernel(k=min(2 * splits, -(-m // 32)))
        times = {k: c3.cuda_ms(v) for k, v in calls.items()}
        _, by_name, _ = chip_smoke.profiled(torch, kernel, 20)
        launches = ", ".join(
            f"{re.search(r'(\w+_kernel)(<\w+>)?', k).group(0)} {v:.4f} ms"
            for k, v in sorted(by_name.items()))
        turns = ""
        if "parent" in libs:
            pf = libs["parent"].fused_block_norm_relu_moments_f32
            pf.argtypes = [P] * 5 + [I] * 5 + [P]
            pf.restype = ctypes.c_int
            if ab.parent_takes_chunk(parent):
                psplits, chunk = ab.simt_grid(m, c, sms)
                ppart = torch.empty(psplits, c, c + 1, device="cuda")
                pargs = ptrs[:3] + [ppart.data_ptr(), out.data_ptr(), n, c,
                                    s, psplits, chunk]
            else:
                pargs = ptrs + [n, c, s, splits, wide]
            both = {"parent": lambda: pf(*pargs, stream),
                    "kernel": calls["kernel"]}
            seq = [(w, c3.cuda_ms(both[w])) for w in
                   ("parent", "kernel", "kernel", "parent")]
            ratio = (seq[1][1] + seq[2][1]) / (seq[0][1] + seq[3][1])
            turns = ("; in turns: " + ", ".join(f"{w} {t:.4f}"
                                                 for w, t in seq)
                     + f" ({ratio:.4f}x)")
        tf32 = 3.0 * c * (c + 1) * m
        moved = 4.0 * (m * c + 2 * c + c * (c + 1))
        t = times["kernel"]
        print(f"norm_relu_moments C {c}, {h}x{h}, batch {n}, {splits} "
              f"split(s), {'16' if wide else '4'}-byte copies: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; the kernel's launches, device time: {launches}"
              + f"; kernel {moved / t / 1e9:.3f} TB/s of "
              f"{moved / 1e9:.4f} GB, {tf32 / t / 1e9:.1f} TFLOP/s of TF32 "
              f"(no copies: {tf32 / times['no copies'] / 1e9:.1f}){turns}; "
              f"the wrapper's largest share of the rtol 1e-5 limit "
              f"{limit:.4f}, M2 symmetric {symmetric}; against float64 "
              f"(Σh, M2): kernel {f64[0][0]:.4f}, {f64[0][1]:.4f}, plain "
              f"{f64[1][0]:.4f}, {f64[1][1]:.4f} [{card}]", flush=True)
        del a2, part, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
