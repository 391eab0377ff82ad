"""Run the paged decode kernel of ``paddle_tpu_torch/csrc/paged_attention.cu``
on the CPU, before any GPU sees it.

The harness of ``scripts/emulate_fused_conv_cpu.py`` (CUDA's qualifiers
defined away, ``threadIdx`` / ``blockIdx`` thread-local, ``gridDim`` set
by each launch, ``__shared__`` static, ``__syncthreads`` a
``std::barrier``, ``__shfl_xor_sync`` an exchange through a per-warp
buffer, the tickets' ``cuda::atomic_ref`` a ``std::atomic_ref``, the blocks of
a launch run one after another in a shuffled order, so that the last
ticket of a (slot, head) falls to a different split from call to call),
with ``__ldcs`` a plain load. Builds ``paged_attention.cu`` and
``common.cuh`` so with ``g++ -std=c++20`` into ``paddle_tpu_torch/_build/``
and calls the wrapper itself, ``flash_attention.paged_decode_attention``,
with ``build.bind`` pointed at the emulation and the output allocated
full of NaN, on CPU tensors:

* the three shapes of the card tests' ``test_paged_kernel_matches_plain``
  (the first is ``chip_smoke.py`` phase 3's: 8 slots, H 8, D 256, BS 16,
  lengths up to 1024 with an idle slot);
* lengths at the split edges (0, 1, P - 1, P, P + 1, the table's whole
  capacity) at D 128 and 256 and BS 4, 8 and 16;
* a table id out of range (-3 and NB + 5) inside a slot's length, which
  reads the null block 0, and others past the length, which are never
  read;
* every slot idle; a slot of 130 P + 7 keys, whose 131 live splits are
  more than the combining block's 128 threads.

For each, in float32 and then in bfloat16 (the same inputs rounded to
bfloat16, through ``paged_decode_attention_bf16``, the bfloat16 instance
of the same source): the largest share of the limit against
``paged_attention_reference`` on the same inputs (given the table with
out-of-range ids set to 0; float32 atol = rtol = 1e-5, bfloat16 2^-7
max|plain| + 2^-7 |plain|, with the share of output values whose bits
differ from the plain version's), idle slots exactly zero, a second
call the same bits (its blocks in another order), and the tickets back
at 0. ``--split`` sets P (the keys a block; the wrapper's
``PAGED_SPLIT_KEYS`` by default), several values to sweep; ``--dtype``
runs one of the two. Exits 1 if any case misses.

    python scripts/emulate_paged_attention_cpu.py [--split 16 64]
        [--dtype float32|bfloat16]
"""

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import emulate_fused_conv_cpu as emu  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 1e-5
BF16_REL = 2.0 ** -7
EMU_H = emu.EMU_H + r"""
struct __attribute__((aligned(8))) uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
template <class T> inline T __ldcs(const T* p) { return *p; }
inline float expf(float x) { return std::exp(x); }
namespace cuda {
enum thread_scope { thread_scope_device };
using std::memory_order_acq_rel;
template <class T, thread_scope S>
struct atomic_ref : std::atomic_ref<T> {
  using std::atomic_ref<T>::atomic_ref;
};
}  // namespace cuda
"""


def compile_library(out: Path) -> ctypes.CDLL:
    out.mkdir(parents=True, exist_ok=True)
    (out / "common.cuh").write_text(emu.rewrite("common.cuh"))
    (out / "paged_attention.cpp").write_text(
        emu.rewrite("paged_attention.cu").replace("#include <cuda/atomic>\n",
                                                  ""))
    (out / "cuda_emu.h").write_text(EMU_H)
    (out / "emu_rt.cpp").write_text(emu.EMU_RT)
    lib = out / "paged_attention_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-ffp-contract=off", "-include", "cuda_emu.h",
                    "-o", str(lib), "paged_attention.cpp", "emu_rt.cpp"],
                   cwd=out, check=True)
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def emulated(lib, split: int):
    """The wrapper takes CPU tensors as the card's, launches the
    emulation with P = split and gets its output full of NaN."""
    def bind(source, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    saved = (build.on_card, build.bind, build.device_guard, build.stream,
             torch.empty_like, fa.PAGED_SPLIT_KEYS)
    build.on_card = lambda name, t: True
    build.bind = bind
    build.device_guard = lambda device: contextlib.nullcontext()
    build.stream = lambda device: 0
    torch.empty_like = lambda t: torch.full_like(t, float("nan"))
    fa.PAGED_SPLIT_KEYS = split
    try:
        yield
    finally:
        (build.on_card, build.bind, build.device_guard, build.stream,
         torch.empty_like, fa.PAGED_SPLIT_KEYS) = saved


def make_case(seed, s, h, d, nb, bs, lens, mb=None, bad_ids=False):
    """(q, k_pool, v_pool, tables, lens): each slot's pages distinct
    blocks of the pool (block 0 the null block), mb = the pages of the
    longest slot + 1 unless given. bad_ids: the first live slot's second
    page (its first where it has one) becomes -3, the next slot's NB + 5,
    and an entry past a length 7 * NB."""
    gen = torch.Generator().manual_seed(seed)
    mb = mb or -(-max(lens) // bs) + 1
    perm = torch.randperm(nb - 1, generator=gen) + 1
    tables = torch.zeros(s, mb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens):
        need = -(-n // bs)
        tables[i, :need] = perm[used:used + need]
        used += need
    if bad_ids:
        live = [i for i, n in enumerate(lens) if n > 0]
        for i, bad in zip(live, (-3, nb + 5)):
            tables[i, min(1, -(-lens[i] // bs) - 1)] = bad
        short = [i for i, n in enumerate(lens) if -(-n // bs) < mb]
        if short:
            tables[short[0], -1] = 7 * nb
    return (torch.randn(s, h, d, generator=gen),
            torch.randn(nb, bs, h, d, generator=gen),
            torch.randn(nb, bs, h, d, generator=gen), tables,
            torch.tensor(lens, dtype=torch.int32))


def expected(args):
    """The plain version on the table with out-of-range ids set to 0
    (what the kernel reads for them)."""
    q, kp, vp, tables, lens = args
    safe = torch.where((tables < 0) | (tables >= kp.shape[0]), 0, tables)
    return fa.paged_attention_reference(q, kp, vp, safe, lens)


def cases(split: int):
    p = split
    yield "test shape 1 (phase 3)", (2, 8, 8, 256, 513, 16,
                                     [1024, 1, 17, 500, 0, 999, 64, 777])
    yield "test shape 2", (3, 3, 2, 128, 12, 8, [13, 0, 40])
    yield "test shape 3", (4, 2, 1, 256, 30, 4, [65, 3])
    for d, bs in ((128, 4), (256, 8), (128, 16)):
        cap = -(-(3 * p + 5) // bs) * bs
        lens = [0, 1, p - 1, p, p + 1, cap]
        nb = 2 + sum(-(-n // bs) for n in lens)
        yield (f"split edges D {d} BS {bs} capacity {cap}",
               (5 + d + bs, 6, 2, d, nb, bs, lens, cap // bs))
    yield "ids out of range", (7, 4, 2, 128, 40, 8, [2 * p + 3, 0, p, 9],
                               None, True)
    yield "every slot idle", (8, 3, 2, 256, 6, 4, [0, 0, 0], 3)
    n = 130 * p + 7
    yield ("more live splits than a block has threads",
           (9, 2, 1, 128, 3 + -(-n // 4), 4, [n, 3]))


def limit_share(got, want, bf16: bool) -> float:
    """The largest share of the limit: 1e-5 in float32; in bfloat16
    2^-7 max|plain| + 2^-7 |plain|, compared in float32."""
    got, want = got.float(), want.float()
    lim = (BF16_REL * want.abs().max() + BF16_REL * want.abs() if bf16
           else TOL + TOL * want.abs())
    return float(((got - want).abs() / lim.clamp_min(1e-30)).max())


def run(lib, split: int, name: str, spec, dtype) -> bool:
    seed, s, h, d, nb, bs, lens, *rest = spec
    mb = rest[0] if rest else None
    bad = rest[1] if len(rest) > 1 else False
    args = make_case(seed, s, h, d, nb, bs, lens, mb, bad)
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    fn = (fa.paged_decode_attention_bf16 if dtype == torch.bfloat16
          else fa.paged_decode_attention)
    with emulated(lib, split):
        got = fn(*args)
        again = fn(*args)
        buf, count = fa._paged_scratch[(args[0].device.index, 0)]
        tickets = buf[:count].view(torch.int32)
        _, n_split = fa.paged_split_plan(args[3].shape[1] * bs)
    want = expected(args)
    bf16 = dtype == torch.bfloat16
    share = limit_share(got, want, bf16)
    differ = float((got != want).float().mean())
    idle = all(bool((got[i] == 0).all()) for i, n in enumerate(lens)
               if n == 0)
    same = torch.equal(got, again)
    zero = int(tickets.abs().sum()) == 0
    limit = "bf16" if bf16 else "1e-5"
    print(f"{str(dtype)[6:]} P {split}, {name}: S {s}, H {h}, D {d}, BS "
          f"{bs}, MB {args[3].shape[1]}, lengths {lens}: {n_split} "
          f"split(s) a (slot, head); largest share of the {limit} limit "
          f"{share:.4f}; values whose bits differ from the plain "
          f"version's {differ:.4f}; idle slots zero {idle}; a second call "
          f"the same bits {same}; tickets back at 0 {zero}", flush=True)
    return share <= 1 and idle and same and zero


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split", type=int, nargs="+",
                    default=[fa.PAGED_SPLIT_KEYS])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    dtypes = ([getattr(torch, args.dtype)] if args.dtype
              else [torch.float32, torch.bfloat16])
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "paged_attention_emulation")
    ok = [run(lib, p, name, spec, dt) for dt in dtypes for p in args.split
          for name, spec in cases(p)]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
