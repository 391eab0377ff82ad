"""Where the time of the port's bwd_apply3 kernel goes, on one GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/bwd_apply3_tc.cuh`` (the
stacked product [amat | bmat]·[g3; h2] in 3xTF32, h2 built on landing,
the masked epilogue and bn2's row partials, then the fixed-order pass of
the partials) and ablations of it, made by removing calls from copies of
the source:

* ``no copies``: no stage copied, the product and the epilogue over
  whatever the ring holds;
* ``no h2``: the a2 rows used as they land, neither turned into h2 nor
  kept for the epilogue;
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;
* ``ring of 2`` and ``ring of 4``: the copies one or three stages ahead
  instead of two (right results, another prefetch depth).

Each build is timed alone with CUDA events at ResNet-50's three
bottleneck-chain stages (batch 128), on the stacked operand the wrapper
makes, and the whole kernel reports what it moves and computes over its
time: its bytes (g3 and a2 read once, g2 written once, the stacked
operand and the vectors once) in TB/s and the product's operations (two
a multiply-add) in TFLOP/s, with the TF32 rate of its three products;
the no-copies build reports the TF32 rate of its mma.sync alone. The
ablations compute nothing useful; the whole wrapper
(``fused_block.bwd_apply3``) is checked against its plain version first
(g2 within atol = rtol = 1e-4, the sums within 1e-5 of the sum of their
terms' magnitudes), and both the kernel's g2 and the plain version's
(float32, TF32 off) are held against the same g2 in float64: which of
the two carries the difference. Run from the repository root on a
machine with the CUDA toolkit: ``python scripts/torch_bwd_apply3_probe.py``.
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
import torch_bwd_final_probe as final_probe  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402

STAGES = [(256, 64, 56), (512, 128, 28), (1024, 256, 14)]   # Cin, C, side
BATCH = 128
HEADER = "bwd_apply3_tc.cuh"
NO_COPY = (("    if (s < stages) stage(s);", "    if (false) stage(s);"),
           ("    if (s + kRing - 1 < stages) stage(s + kRing - 1);",
            "    if (false) stage(s + kRing - 1);"))
NO_H2 = (("    land<BM, WIDE>(", "    if (false) land<BM, WIDE>("),)
RING = "constexpr int kRing = 3;"
VARIANTS = {"kernel": (), "no copies": NO_COPY, "no h2": NO_H2,
            "no mma": final_probe.NO_MMA,
            "ring of 2": ((RING, RING.replace("3", "2")),),
            "ring of 4": ((RING, RING.replace("3", "4")),)}
ENTRY = """
#include "{dir}/bwd_apply3_tc.cuh"
extern "C" int apply3(const float* g3, const float* a2, const float* sc2,
                      const float* sh2, const float* amat, const float* v0,
                      const float* inv2, const float* m2, float* g2,
                      float* part, float* stats, int N, int Cin, int C,
                      int S, int lda, int T, int wide, void* s) {{
  return bwd_apply3::launch(g3, a2, sc2, sh2, amat, v0, inv2, m2, g2, part,
                            stats, N, Cin, C, S, lda, T, wide,
                            static_cast<cudaStream_t>(s));
}}
"""
P, I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [P] * 11 + [I] * 7 + [P]


def compile_variants(out_dir: Path, variants=VARIANTS, entry=ENTRY,
                     symbol="apply3", argtypes=ARGTYPES,
                     edited=(HEADER,)) -> dict:
    """{name: entry point `symbol` of that variant's build}, built in
    parallel from copies of the headers, each of a variant's substitutions
    made in every header of `edited` that holds it; prints the kernel's
    registers and spills."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    headers = ("fused_block.cuh", "conv3x3_tc.cuh", HEADER) + tuple(
        h for h in edited if h != HEADER)
    for i, (name, subs) in enumerate(variants.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(exist_ok=True)
        texts = {h: (build.CSRC / h).read_text() for h in headers}
        for old, new in subs:
            holders = [h for h in edited if old in texts[h]]
            if not holders:
                raise RuntimeError(f"{name}: no header of {edited} has "
                                   f"{old!r}")
            for h in holders:
                texts[h] = texts[h].replace(old, new)
        for h, text in texts.items():
            (vdir / h).write_text(text)
        unit, lib = vdir / "probe.cu", vdir / "probe.so"
        unit.write_text(entry.format(dir=vdir))
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(unit)],
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
        f = getattr(ctypes.CDLL(str(lib)), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        fns[name] = f
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
    fns = compile_variants(build.BUILD_DIR / "bwd_apply3_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def col(v):
        return v.reshape(1, -1, 1)

    for cin, c, side in STAGES:
        n, s = BATCH, side * side
        g3, a2 = randn(n, cin, s), randn(n, c, s)
        sc2, sh2 = 1 + 0.2 * randn(c), 0.1 * randn(c)
        w3 = randn(cin, c) * (2 / c) ** 0.5
        p3, q3, r3 = 1 + 0.2 * randn(cin), 0.01 * randn(cin), 0.01 * randn(cin)
        amat = (w3 * p3[:, None]).T.contiguous()
        bmat = w3.T @ (w3 * q3[:, None])
        v0, m2 = w3.T @ r3, 0.1 * randn(c)
        inv2 = (1 + 0.2 * randn(c)).abs()
        args = (g3, a2, sc2, sh2, amat, bmat, v0, inv2, m2)
        got = fb.bwd_apply3(*args)
        want = fb.bwd_apply3_reference(*args)
        torch.cuda.synchronize()
        xhat = a2 * col(inv2) + col(-m2 * inv2)
        g2_share = float(((got[0] - want[0]).abs()
                          / (1e-4 + 1e-4 * want[0].abs())).max())
        sum_share = max(
            float(((got[i] - want[i]).abs() / (1e-5 * t)).max())
            for i, t in ((1, want[0].abs().sum(dim=(0, 2))),
                         (2, (want[0] * xhat).abs().sum(dim=(0, 2)))))
        assert g2_share <= 1 and sum_share <= 1, (g2_share, sum_share)
        # g2 in float64 under the plain version's mask
        mask = a2 * col(sc2) + col(sh2) > 0
        h2 = torch.clamp_min(a2.double() * col(sc2).double()
                             + col(sh2).double(), 0.0)
        exact = torch.where(mask, torch.matmul(amat.double(), g3.double())
                            + torch.matmul(bmat.double(), h2)
                            + col(v0).double(), torch.zeros((), device="cuda",
                                                            dtype=torch.float64))
        del h2

        def share(v):
            return float(((v.double() - exact).abs()
                          / (1e-4 + 1e-4 * exact.abs())).max())
        f64 = (share(got[0]), share(want[0]))
        del got, want, exact, xhat, mask
        _, t, rows, lda = fb._stream_grid(n, s, c, cin + c)
        stacked = torch.nn.functional.pad(torch.cat([amat, bmat], 1),
                                          (0, lda - cin - c, 0, rows - c))
        g2 = torch.empty_like(a2)
        part = torch.empty(2, c, t, device="cuda")
        stats = torch.empty(2, c, device="cuda")
        ptrs = [x.data_ptr() for x in (g3, a2, sc2, sh2, stacked, v0, inv2,
                                       m2, g2, part, stats)]
        ptrs += [n, cin, c, s, lda, t, int(s % 4 == 0)]
        times = {}
        for name, f in fns.items():
            def call(f=f, name=name):
                err = f(*ptrs, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            times[name] = c3.cuda_ms(call)
        m = n * s
        ops = 2.0 * c * (cin + c) * m
        moved = 4.0 * (m * (cin + 2 * c) + c * (cin + c) + 7 * c)
        ms = times["kernel"]
        print(f"bwd_apply3 Cin {cin}, C {c}, {side}x{side}, batch {n}, "
              f"{t} column tiles: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; kernel {moved / ms / 1e9:.3f} TB/s of "
              f"{moved / 1e9:.3f} GB, {ops / ms / 1e9:.1f} TFLOP/s of the "
              f"product's {ops / 1e9:.2f} GFLOP, "
              f"{3 * ops / ms / 1e9:.1f} TFLOP/s of TF32 (no copies: "
              f"{3 * ops / times['no copies'] / 1e9:.1f}); the wrapper's "
              f"largest share of its limits: g2 {g2_share:.4f}, sums "
              f"{sum_share:.4f}; g2 against float64: kernel {f64[0]:.4f}, "
              f"plain {f64[1]:.4f} [{card}]", flush=True)
        del g3, a2, g2, part, stacked
    return 0


if __name__ == "__main__":
    sys.exit(main())
