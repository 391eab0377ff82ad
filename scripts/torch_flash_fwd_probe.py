"""Where the time of the port's flash-attention forward goes, on one GPU.

Builds the kernel of ``paddle_tpu_torch/csrc/flash_attention.cu`` (Q·Kᵀ
and P·V in 3xTF32 on the tensor cores, V landing under Q·Kᵀ and the next
K under the softmax and P·V) and ablations of it, made by removing calls
from copies of the source:

* ``no copies``: the key tiles' K and V never copied (Q and the first K
  tile still land once a block), the products over whatever shared
  memory holds;
* ``no mma``: the fragment reads and the 3xTF32 splits kept, each
  mma.sync replaced by an integer mix of its operands;
* ``no softmax``: the softmax row pass skipped (the scores still go to
  shared memory and P·V reads them as they are);

and, with ``--parent DIR``, the kernel of another tree (DIR holds its
``paddle_tpu_torch/csrc``), e.g. the parent unpacked by ``git archive``:
its SASS against this tree's, function by function, its O and lse
against this tree's, bit for bit, and its time in turns.
At each of chip_smoke.py's FLASH_SHAPES (H 8, D 256, causal) every build
is timed with CUDA events, in turns (the list, then the list reversed),
and the kernel reports its TF32 rate: three TF32 products of 4·D flops
per visible (query, key) pair. The ablations compute nothing useful; the
wrapper (``flash_attention.flash_attention_fwd``) is checked against its
plain version first (O and lse within atol = rtol = 1e-5, as phase 3
holds them), two calls bit-identical, and both the kernel's O and lse and
the plain version's (float32, TF32 off) are held against the same in
float64: which of the two carries the difference. Last, one call of
PyTorch's scaled_dot_product_attention is profiled and its kernels' names
printed, with SDPA's time beside the kernel's. Run from the repository
root on a machine with the CUDA toolkit:
``python scripts/torch_flash_fwd_probe.py [--parent DIR]``.
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

from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
import torch_chain_ab as ab  # noqa: E402
import torch_conv3x3_probe as c3  # noqa: E402

SHAPES = ((1, 128), (1, 1024), (1, 333), (8, 1024))   # (batch, sequence)
H, D = 8, 256
TF32_FLOPS_PER_S = 495e12
SOURCE = "flash_attention.cu"
NO_COPY = (("    copy_tile<D, D, true>(sV, vb, k0, sk, stride);",
            "    if (false) copy_tile<D, D, true>(sV, vb, k0, sk, stride);"),
           ("    if (kt + 1 < n_tiles) copy_tile<",
            "    if (false) copy_tile<"))
NO_MMA = (
    ("        mma0(f[st][i][j], as[st][i], bb[st][j][0], bb[st][j][1]);",
     "        for (int r = 0; r < 4; ++r) f[st][i][j][r] = __uint_as_float("
     "as[st][i][r] ^ bb[st][j][r & 1]);"),
    ("        mma(f[st][i][j], ab[st][i], bs[st][j][0], bs[st][j][1]);",
     "        for (int r = 0; r < 4; ++r) f[st][i][j][r] += __uint_as_float("
     "ab[st][i][r] ^ bs[st][j][r & 1]);"),
    ("        mma(f[st][i][j], ab[st][i], bb[st][j][0], bb[st][j][1]);",
     "        for (int r = 0; r < 4; ++r) f[st][i][j][r] += __uint_as_float("
     "ab[st][i][r] ^ bb[st][j][r & 1]);"))
NO_SOFTMAX = (("    // lane + 32; the rows' reductions interleaved\n    {",
               "    if (false) {"),)
VARIANTS = {"kernel": (), "no copies": NO_COPY, "no mma": NO_MMA,
            "no softmax": NO_SOFTMAX}
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def compile_variants(out_dir: Path, parent, source=SOURCE,
                     variants=VARIANTS, symbol="flash_attention_fwd_f32",
                     argtypes=(P,) * 5 + (I,) * 5 + (FL, I, P)):
    """{name: (entry point, library path)} of each variant of `source`:
    the source and every header of its csrc, each substitution made in
    the file that holds it, built in parallel; with `parent`, that tree's
    source and headers as they are."""
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: (build.CSRC, subs) for name, subs in variants.items()}
    if parent is not None:
        sources["parent"] = (Path(parent) / "paddle_tpu_torch" / "csrc", ())
    jobs = {}
    for i, (name, (csrc, subs)) in enumerate(sources.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(exist_ok=True)
        files = {f.name: f.read_text() for f in sorted(csrc.glob("*.cuh"))}
        files[source] = (csrc / source).read_text()
        for old, new in subs:
            hits = [f for f, text in files.items() if old in text]
            if not hits:
                raise RuntimeError(f"{name}: no file has {old!r}")
            for f in hits:
                files[f] = files[f].replace(old, new)
        for f, text in files.items():
            (vdir / f).write_text(text)
        unit, lib = vdir / source, vdir / "probe.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(unit)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name in ("kernel", "parent"):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        f = getattr(ctypes.CDLL(str(lib)), symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        fns[name] = (f, lib)
    return fns


def same_sass(libs, kernel: str) -> str:
    """How many of the functions whose names hold `kernel` have the same
    SASS in two libraries, function by function."""
    a, b = (ab.sass(lib) for lib in libs)
    names = sorted(k for k in set(a) | set(b) if kernel in k)
    same = [k for k in names if a.get(k) == b.get(k)]
    notes = []
    for k in sorted(set(names) - set(same)):
        pairs = zip(a.get(k, "").splitlines(), b.get(k, "").splitlines())
        first = next((x for x in pairs if x[0] != x[1]), None)
        notes.append(f"\n  {k} differs first at {first}")
    return (f"SASS of {kernel} identical in {len(same)} of {len(names)}"
            + "".join(notes))


def exact(q, k, v):
    """O and lse of causal attention in float64 (the plain version's
    arithmetic, which computes in float32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * D ** -0.5
    pos = torch.arange(q.shape[1], device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, fa.DEFAULT_MASK_VALUE)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.double())
    return o, torch.logsumexp(s, dim=-1).reshape(-1, q.shape[1])


def sdpa_kernels(qt, kt, vt) -> str:
    """The names of the device kernels of one SDPA call, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    return "; ".join(sorted(names)) or "the profiler saw no device kernel"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a tree whose flash forward kernel to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    built = compile_variants(build.BUILD_DIR / "flash_fwd_probe", args.parent)
    fns = {name: fn for name, (fn, _) in built.items()}
    if "parent" in built:
        print(same_sass((built["parent"][1], built["kernel"][1]),
                        "flash_fwd_tc_kernel"), "(this tree against the "
              "parent's)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s in SHAPES:
        q, k, v = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=True)
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(o, o2) and torch.equal(lse, lse2))

        def share(got, want):
            return float(((got.double() - want).abs()
                          / (1e-5 + 1e-5 * want.abs())).max())
        limit = (share(o, ro.double()), share(lse, rlse.double()))
        assert max(limit) <= 1 and repeat, (limit, repeat)
        eo, el = exact(q, k, v)
        f64 = {"kernel": (share(o, eo), share(lse, el)),
               "plain": (share(ro, eo), share(rlse, el))}
        del eo, el, ro, rlse, o2, lse2
        out = torch.empty_like(q)
        lout = torch.empty(b * H, s, device="cuda")
        ptrs = [x.data_ptr() for x in (q, k, v, out, lout)]
        if "parent" in fns:
            for name in ("kernel", "parent"):
                err = fns[name](*ptrs, b, H, s, s, D, D ** -0.5, 1, stream)
                assert err == 0, (name, err)
                if name == "kernel":
                    mine = (out.clone(), lout.clone())
            torch.cuda.synchronize()
            parent_same = bool(torch.equal(out, mine[0])
                               and torch.equal(lout, mine[1]))
            del mine
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                def call(f=fns[name], name=name):
                    err = f(*ptrs, b, H, s, s, D, D ** -0.5, 1, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times[name].append(c3.cuda_ms(call))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = c3.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        pairs = b * H * s * (s + 1) // 2
        tf32 = 3 * 4 * D * pairs
        print(f"flash_attention_fwd B {b}, S {s}, H {H}, D {D}, causal: "
              + "; ".join(f"{name} {m:.4f} ms ("
                          + ", ".join(f"{t:.4f}" for t in times[name]) + ")"
                          for name, m in ms.items())
              + f"; sdpa {sdpa:.4f} ms; kernel {tf32 / ms['kernel'] / 1e9:.1f}"
              f" TFLOP/s of TF32 ({tf32 / 1e9:.2f} GFLOP, bound "
              f"{1e3 * tf32 / TF32_FLOPS_PER_S:.4f} ms); largest share of the "
              f"1e-5 limit: O {limit[0]:.4f}, lse {limit[1]:.4f}; two calls "
              f"bit-identical {repeat}"
              + (f"; the parent's O and lse bit-identical {parent_same}"
                 if "parent" in fns else "")
              + f"; against float64: kernel O "
              f"{f64['kernel'][0]:.4f} lse {f64['kernel'][1]:.4f}, plain O "
              f"{f64['plain'][0]:.4f} lse {f64['plain'][1]:.4f} [{card}]",
              flush=True)
        if (b, s) == SHAPES[-1]:
            print(f"sdpa kernels at B {b}, S {s}: {sdpa_kernels(qt, kt, vt)}")
        del q, k, v, o, lse, out, lout
    return 0


if __name__ == "__main__":
    sys.exit(main())
