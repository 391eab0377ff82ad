"""Where the time of the port's bwd_reduce3 kernel goes, on one GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/bwd_reduce3.cuh`` and three
ablations of it, made by removing one call from a copy of the source:

* ``product only``: no copies and no conversions (the product of
  whatever the ring holds);
* ``copies only``: no conversions and no product;
* ``copies + conversions``: no product (g3 still stored).

Each is timed with CUDA events at ResNet-50's three bottleneck-chain
stages (batch 128), beside the whole kernel. The ablations compute
nothing useful; only the whole kernel is checked against the plain
version. Run from the repository root on a machine with the CUDA
toolkit: ``python scripts/torch_bwd_reduce3_probe.py``.
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

STAGES = [(256, 64, 56), (512, 128, 28), (1024, 256, 14)]   # Cin, C, side
BATCH = 128
TRANSFORM = "    transform<BN, WIDE>(st,"
PRODUCT = "    product<TN>(acc, st,"
COPY = "    if (s < stages)\n      copy_stage<"
NO_COPY = (COPY, "    if (false)\n      copy_stage<")
NO_TRANSFORM = (TRANSFORM, "    if (false) transform<BN, WIDE>(st,")
NO_PRODUCT = (PRODUCT, "    if (false) product<TN>(acc, st,")
VARIANTS = {"whole kernel": (),
            "product only": (NO_COPY, NO_TRANSFORM),
            "copies only": (NO_TRANSFORM, NO_PRODUCT),
            "copies + conversions": (NO_PRODUCT,)}
ENTRY = """
#include "{header}"
extern "C" int probe(const float* dout, const float* out, const float* a2,
                     const float* sc2, const float* sh2, float* g3,
                     float* part, float* red, int N, int Cin, int C, int S,
                     int splits, int chunk, void* stream) {{
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64)
    return reduce3::launch<64, true>(dout, out, a2, sc2, sh2, g3, part, red,
                                     Cin, C, S, N * S, splits, chunk, s);
  return reduce3::launch<128, true>(dout, out, a2, sc2, sh2, g3, part, red,
                                    Cin, C, S, N * S, splits, chunk, s);
}}
"""


def compile_variants(out_dir: Path) -> dict:
    source = (build.CSRC / "bwd_reduce3.cuh").read_text()
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
        fn = ctypes.CDLL(str(lib)).probe
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    fns = compile_variants(build.BUILD_DIR / "reduce3_probe")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = build.sm_count(torch.device("cuda", 0))
    stream = torch.cuda.current_stream().cuda_stream
    for cin, c, h in STAGES:
        n, s = BATCH, h * h
        dout, out = (torch.randn(n, cin, s, device="cuda", generator=gen)
                     for _ in range(2))
        a2 = torch.randn(n, c, s, device="cuda", generator=gen)
        sc = torch.rand(c, device="cuda", generator=gen) + 0.5
        sh = torch.rand(c, device="cuda", generator=gen) - 0.2
        splits, chunk, wide = fb._reduce3_grid(n, s, cin, c, sms)
        assert wide
        g3 = torch.empty_like(dout)
        part = torch.empty(splits, cin, c + 1, device="cuda")
        red = torch.empty(cin, c + 1, device="cuda")
        times = {}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(dout.data_ptr(), out.data_ptr(), a2.data_ptr(),
                         sc.data_ptr(), sh.data_ptr(), g3.data_ptr(),
                         part.data_ptr(), red.data_ptr(), n, cin, c, s,
                         splits, chunk, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            if name == "whole kernel":
                call()
                want = fb.bwd_reduce3_reference(dout, out, a2, sc, sh)
                torch.cuda.synchronize()
                assert torch.equal(g3, want[0])
                terms = torch.einsum("nis,ncs->ic", want[0].abs(),
                                     fb._norm_relu(a2, sc, sh))
                assert bool(((red[:, :c] - want[1]).abs()
                             <= 1e-5 * terms).all())
                del want, terms
            times[name] = cuda_ms(call)
        print(f"bwd_reduce3 Cin {cin}, C {c}, {h}x{h}, batch {n}, {splits} "
              f"splits: " + "; ".join(f"{k} {v:.4f} ms"
                                      for k, v in times.items())
              + f" [{card}]", flush=True)
        del dout, out, a2, g3, part, red
    return 0


if __name__ == "__main__":
    sys.exit(main())
