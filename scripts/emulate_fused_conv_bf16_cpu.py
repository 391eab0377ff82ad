"""Run the bfloat16 conv-epilogue kernels of
``paddle_tpu_torch/csrc/fused_conv.cu`` on the CPU, before any GPU sees
them.

The source is built for g++ as ``scripts/emulate_fused_conv_cpu.py``
builds it (CUDA's qualifiers defined away, a thread a CUDA thread, the
blocks of a launch in a shuffled order, ``atomicAdd`` on the tickets a
``std::atomic_ref``; ``uint4`` loads and the bit casts as plain C++), and
the bfloat16 wrappers themselves are called on CPU tensors
(``fused_conv.channel_stats_bf16``, ``apply_epilogue_bf16``,
``apply_epilogue_add_bf16``, with ``build.bind`` pointed at the
emulation, ``build.sm_count`` at ``--sms`` and every output allocated
full of NaN) at each N,C,S given: a = randn + 0.5 and the addend randn,
both rounded to bfloat16, scale and shift float32. It prints the plan
(lanes, column ranges of 8 * lanes elements, row slices, tickets), the
stats' largest share of their limit (1e-5 of the sum of their terms'
magnitudes) against the plain version, whether a second call gives the
same bits (the tickets set back to 0), and for apply, with and without
the addend and the ReLU, the largest share of the bfloat16 limit (2^-7
max|plain| + 2^-7 |plain|), the share of elements whose bits differ from
the plain version and the largest difference in bfloat16 steps (the
kernel's one fmaf against the plain version's product then sum can round
to the neighbouring value, and further where a·scale cancels shift:
information, not a limit). Exits 1 if any shape misses.

    python scripts/emulate_fused_conv_bf16_cpu.py 4,64,49 3,5,35 2,7,13 \\
        2,64,12544 2,2048,49
"""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from emulate_fused_conv_cpu import compile_library, emulated  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_conv as fc  # noqa: E402

BF16_REL = 2.0 ** -7
STATS_RTOL = 1e-5


def steps_apart(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bfloat16 steps (the distance of their bit patterns
    on the ordered line of bfloat16 values)."""
    def ordered(x):
        b = x.view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7fff), b)
    return (ordered(got) - ordered(want)).abs()


def case(lib, sms, n, c, s):
    gen = torch.Generator().manual_seed(1000 * n + 10 * c + s)
    a = (torch.randn(n, c, s, generator=gen) + 0.5).bfloat16()
    d = torch.randn(n, c, s, generator=gen).bfloat16()
    sc = torch.rand(c, generator=gen) + 0.5
    sh = torch.randn(c, generator=gen)
    with emulated(lib, sms):
        got = fc.channel_stats_bf16(a)
        again = fc.channel_stats_bf16(a)
        plan = fc._plans(n, c, s, a.device.index, 8)
        ys = {(add, relu): (fc.apply_epilogue_add_bf16(a, sc, sh, d, relu)
                            if add else fc.apply_epilogue_bf16(a, sc, sh,
                                                               relu))
              for add in (False, True) for relu in (False, True)}
        buf, count = fc._scratch[(a.device.index, 0)]
        tickets = buf[:count].view(torch.int32)
    want = fc.channel_stats_reference(a)
    af = a.float()
    terms = (af.abs().sum(dim=(0, 2)), (af * af).sum(dim=(0, 2)))
    stats = max(float(((g - w).abs() / (STATS_RTOL * m)).max())
                for g, w, m in zip(got, want, terms))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    share, differ, worst = 0.0, 0, 0
    for (add, relu), y in ys.items():
        w = fc.apply_epilogue_reference(a, sc, sh, d if add else None, relu)
        if y.dtype != torch.bfloat16 or not bool(torch.isfinite(y).all()):
            share = float("inf")
            continue
        lim = BF16_REL * w.float().abs().max() + BF16_REL * w.float().abs()
        share = max(share, float(((y.float() - w.float()).abs() / lim)
                                 .max()))
        apart = steps_apart(y, w)
        differ += int((apart > 0).sum())
        worst = max(worst, int(apart.max()))
    (lanes, rows, _), (_, arows) = plan
    ranges = -(-c * s // (8 * lanes))
    print(f"N {n}, C {c}, S {s}: {'16-byte' if c * s % 8 == 0 else 'scalar'}"
          f" rows, lanes {lanes}, {ranges} column range(s) x "
          f"{-(-n // rows)} slice(s) (apply x {-(-n // arows)}), "
          f"{-(-c // fc._GROUP)} ticket(s); largest share of the limit: "
          f"stats {stats:.4f}, apply {share:.4f}; apply elements whose bits "
          f"differ {differ} of {4 * n * c * s} (by at most {worst} bf16 "
          f"steps); a second call the same bits {same}; tickets back at 0 "
          f"{int(tickets.abs().sum()) == 0}", flush=True)
    return (stats <= 1 and share <= 1 and same
            and int(tickets.abs().sum()) == 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="+", help="N,C,S")
    ap.add_argument("--sms", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = compile_library(build.BUILD_DIR / "fused_conv_bf16_emulation")
    ok = [case(lib, args.sms, *map(int, sh.split(",")))
          for sh in args.shapes]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
