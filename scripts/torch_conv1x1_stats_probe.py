"""Where the time of the port's conv1x1_stats kernel goes, on one GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/conv1x1_stats_tc.cuh``
(W1·x in 3xTF32 ``mma.sync`` on ``bwd_apply3_tc.cuh``'s product, x by
``cp.async`` through a ring of 3, y and its per-tile row sums in the
epilogue, then the fixed-order pass of the partials) and variants of it,
made by editing copies of the two headers (``compile_variants`` of
``torch_bwd_apply3_probe.py``):

* ``no copies``: no stage copied (the product and the epilogue over
  whatever the ring holds);
* ``one product``: big·big alone, plain TF32, in place of the three
  products;
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;

and, with ``--parent DIR`` (DIR holds another tree's
``paddle_tpu_torch/csrc``, e.g. the parent unpacked by ``git
archive``), that tree's ``fused_block.cu`` entry point (a parent whose
entry point takes W1 itself and no row pitch, the float32 SIMT
kernel's, is called so), timed in turns with this tree's kernel
(parent, kernel, kernel, parent); ``F.conv2d`` of the same product
(cuDNN, TF32 off) is timed in turns with the kernel too.

Each runs at ResNet-50's three bottleneck-chain stages (batch 128) on
chip_smoke's chain inputs (x >= 0, He-scaled W1), timed with CUDA
events; the kernel reports its bytes (x read once, y written once, W1
once) in TB/s and its TF32 operations (three products, two operations
a multiply-add) in TFLOP/s. The variants compute nothing useful; the
wrapper (``fused_block.conv1x1_stats``) is checked against its plain
version first (y within atol = rtol = 1e-5, Σy and Σy² within 1e-5 of
their terms' sums), and both the kernel's y and the plain version's
(float32, TF32 off) are held against y computed in float64: which of
the two carries the difference. Run from the repository root on a
machine with the CUDA toolkit:
``python scripts/torch_conv1x1_stats_probe.py [--parent DIR]``.
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

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_block as fb  # noqa: E402
import torch_bwd_apply3_probe as a3  # noqa: E402
import torch_bwd_final_probe as final_probe  # noqa: E402
import torch_chain_ab as ab  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402

ONE_PRODUCT = tuple(zip((old for old, _ in final_probe.NO_MMA),
                        ("          ;", "          ;",
                         "          mma0(f[jj][i], ab[i], bb[jj][0], "
                         "bb[jj][1]);")))
VARIANTS = {"kernel": (), "no copies": a3.NO_COPY,
            "one product": ONE_PRODUCT, "no mma": final_probe.NO_MMA}
ENTRY = """
#include "{dir}/conv1x1_stats_tc.cuh"
extern "C" int stats(const float* x, const float* w, float* y, float* part,
                     float* stats, int N, int Cin, int C, int S, int lda,
                     int T, int wide, void* s) {{
  return conv1x1_stats::launch(x, w, y, part, stats, N, Cin, C, S, lda, T,
                               wide, static_cast<cudaStream_t>(s));
}}
"""
# the kernel's stage calls are in its own header, the product in
# bwd_apply3's
EDITED = ("conv1x1_stats_tc.cuh", a3.HEADER)
P, I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [P] * 5 + [I] * 7 + [P]


def parent_entry(parent: Path, out_dir: Path):
    """The parent's conv1x1_stats entry point, its fused_block.cu built
    with this tree's flags."""
    lib = out_dir / "parent.so"
    log = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
         str(parent / "paddle_tpu_torch" / "csrc" / "fused_block.cu")],
        capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for the parent:\n{log.stdout}"
                           f"{log.stderr}")
    fn = ctypes.CDLL(str(lib)).fused_block_conv1x1_stats_f32
    old = ab.parent_takes_no_pitch(parent)
    fn.argtypes = [P] * 5 + [I] * (5 if old else 7) + [P]
    fn.restype = ctypes.c_int
    return fn, old


def in_turns(first, second):
    """(first's ms, second's ms, second / first), timed first, second,
    second, first."""
    a0, b0, b1, a1 = (c3.cuda_ms(f) for f in (first, second, second, first))
    return (a0 + a1) / 2, (b0 + b1) / 2, (b0 + b1) / (a0 + a1)


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
    out_dir = build.BUILD_DIR / "conv1x1_stats_probe"
    fns = a3.compile_variants(out_dir, VARIANTS, ENTRY, "stats", ARGTYPES,
                              EDITED)
    parent = None
    if args.parent is not None:
        parent = parent_entry(args.parent.resolve(), out_dir)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(17)
    n = chip_smoke.RESNET["batch"]
    for cin, c, h in chip_smoke.CHAIN_SHAPES:
        s, m = h * h, n * h * h
        d = chip_smoke.chain_case(torch, n, cin, c, h, gen)
        x, w1 = d["x"], d["w1"]
        del d
        got = fb.conv1x1_stats(x, w1)
        want = fb.conv1x1_stats_reference(x, w1)
        torch.cuda.synchronize()
        y_share = chip_smoke.limit_share(torch, got[0], want[0])
        sums = max(float(((g - w).abs() / (1e-5 * t)).max())
                   for g, w, t in ((got[1], want[1],
                                    want[0].abs().sum(dim=(0, 2))),
                                   (got[2], want[2], want[2])))
        assert y_share <= 1 and sums <= 1, (y_share, sums)
        exact = torch.matmul(w1.double(), x.double())
        f64 = [float(((v.double() - exact).abs()
                      / (1e-5 + 1e-5 * exact.abs())).max())
               for v in (got[0], want[0])]
        del got, want, exact
        bn, t, rows, lda = fb._stream_grid(n, s, c, cin)
        assert (rows, lda) == (c, cin), "the chain's W1 needs no copy"
        y = torch.empty(n, c, s, device="cuda")
        part = torch.empty(2, c, t, device="cuda")
        stats = torch.empty(2, c, device="cuda")
        ptrs = [v.data_ptr() for v in (x, w1, y, part, stats)]
        calls = {}
        for name, f in fns.items():
            def call(f=f, name=name):
                err = f(*ptrs, n, cin, c, s, lda, t, 1, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            calls[name] = call
        times = {k: c3.cuda_ms(v) for k, v in calls.items()}
        x4, w4 = x.view(n, cin, h, h), w1.view(c, cin, 1, 1)
        turns = {"F.conv2d": in_turns(lambda: F.conv2d(x4, w4),
                                      calls["kernel"])}
        if parent is not None:
            pf, old = parent
            pargs = ptrs + ([n, cin, c, s, -(-n * s // 128)] if old
                            else [n, cin, c, s, lda, t, 1])
            turns["parent"] = in_turns(lambda: pf(*pargs, stream),
                                       calls["kernel"])
        tf32 = 3 * 2.0 * c * cin * m
        moved = 4.0 * (m * (cin + c) + c * cin + 2 * c)
        ms = times["kernel"]
        print(f"conv1x1_stats Cin {cin}, C {c}, {h}x{h}, batch {n}, "
              f"{rows * bn // 8192 * t} blocks: " + "; ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items())
              + f"; kernel {moved / ms / 1e9:.3f} TB/s of "
              f"{moved / 1e9:.3f} GB, {tf32 / ms / 1e9:.1f} TFLOP/s of "
              f"TF32 (no copies: {tf32 / times['no copies'] / 1e9:.1f}); "
              f"in turns: " + "; ".join(
                  f"{k} {a:.4f} against the kernel's {b:.4f} ({r:.4f}x)"
                  for k, (a, b, r) in turns.items())
              + f"; the wrapper's largest share of its limits: y "
              f"{y_share:.4f}, Σy and Σy² {sums:.4f}; y against float64: "
              f"kernel {f64[0]:.4f}, plain {f64[1]:.4f} [{card}]",
              flush=True)
        del x, w1, y, part, x4, w4
    return 0


if __name__ == "__main__":
    sys.exit(main())
