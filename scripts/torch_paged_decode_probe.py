"""Where the time of the port's paged decode kernel goes, on one GPU.

At ``chip_smoke.py`` phase 3's shape (8 slots, H 8, D 256, BS 16, the
lengths ``chip_smoke.PAGED_LENS``, 55.5 MB a call), through the wrapper
``flash_attention.paged_decode_attention``:

* the output against ``paged_attention_reference`` (atol = rtol = 1e-5),
  the idle slot exactly zero, two calls bit for bit;
* the time a call on one pool pair and over six distinct pool pairs in
  turn (as the decode step's six layers read them): device ms by
  ``torch.profiler``, and back-to-back times by CUDA events, of the
  entry point's launches alone (the arguments of one wrapper call
  replayed) and of wrapper calls (which the wrapper's host time sets);
  CUDA launches a call, host us a call (200 calls queued with no sync)
  and each piece of it; TB/s and the share of the bytes bound (3.35
  TB/s);
* with ``--parent DIR`` (DIR holds another tree, e.g. the parent unpacked
  by ``git archive``), that tree's ``kernels/flash_attention.py`` with its
  own ``build.py`` (its kernels built from its ``csrc`` into its
  ``_build``), measured the same way in turns with this tree's (this,
  parent, parent, this), its output within 1e-5 of this tree's; each
  ``--also DIR`` another tree so, in the same turns;
* P, the keys a block, swept over 16, 32, 64, 128, 256 and 512 at three
  sets of lengths (phase 3's; every slot at 1024; every slot at 128);
* builds of ``paged_attention.cu`` with the source changed: without the V
  loads (V read as K), without the combine (every block writes its
  partial as the output), with 1, 4 or 8 keys in flight a warp instead of
  2, with 2 or 8 warps a block instead of 4, with L1-cached loads
  (``__ldg``) instead of streaming ones (``__ldcs``), without the
  register cap (``__launch_bounds__``' 8 blocks an SM), and combining 4
  partials at a time instead of 8, each timed in turns with the source as
  it is (built the same way), by events around its launches alone, at
  phase 3's lengths and with every slot at 1024;
* ptxas' registers, stack and spills of every build.

Run from the repository root on a machine with the CUDA toolkit:
``python scripts/torch_paged_decode_probe.py [--parent DIR] [--also DIR]``.
"""

import argparse
import contextlib
import ctypes
import importlib
import re
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = "paged_attention.cu"
TOL = 1e-5
VARIANTS = {
    "as it is": (),
    "no V loads": (("vr[u][w] = __ldcs(vrow + lane + 32 * w);",
                    "vr[u][w] = kr[u][w];"),),
    "no combine": (("if (n_live == 1) {", "if (true) {"),),
    "1 key in flight": (("kInFlight = 2;", "kInFlight = 1;"),),
    "4 keys in flight": (("kInFlight = 2;", "kInFlight = 4;"),),
    "8 keys in flight": (("kInFlight = 2;", "kInFlight = 8;"),),
    "2 warps": (("kWarps = 4;", "kWarps = 2;"),),
    "8 warps": (("kWarps = 4;", "kWarps = 8;"),),
    "L1-cached loads": (("__ldcs(", "__ldg("),),
    "no register cap": (("__launch_bounds__(kThreads, kBlocksPerSM)",
                         "__launch_bounds__(kThreads)"),),
    "combine 4 at a time": (("kCombine = 8;", "kCombine = 4;"),),
}
SPLITS = (16, 32, 64, 128, 256, 512)
# the variants that compute the same output (held to the limit once)
CORRECT = ("1 key in flight", "4 keys in flight", "8 keys in flight",
           "2 warps", "8 warps", "L1-cached loads", "no register cap",
           "combine 4 at a time")


def parent_module(parent: Path, package: str = "_parent_kernels"):
    """The other tree's kernels/flash_attention.py, imported with its own
    build.py as the package `package`."""
    pkg = types.ModuleType(package)
    pkg.__path__ = [str(parent / "paddle_tpu_torch" / "kernels")]
    sys.modules[package] = pkg
    return importlib.import_module(f"{package}.flash_attention")


def compile_variants(out_dir: Path):
    """({name: library}, {name: ptxas log}) of builds of paged_attention.cu
    with VARIANTS' substitutions, built in parallel."""
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        text = (build.CSRC / SOURCE).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {SOURCE} has no {old!r}")
            text = text.replace(old, new)
        (vdir / SOURCE).write_text(text)
        (vdir / "common.cuh").write_text(
            (build.CSRC / "common.cuh").read_text())
        lib = vdir / "paged_attention.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(vdir / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(lib)), log
    return libs, logs


def registers(log: str) -> list:
    """ptxas' stack, spills and registers of each paged kernel instance."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if "paged" in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


@contextlib.contextmanager
def library(lib):
    """The wrapper launches `lib`'s entry point instead of its own."""
    def bind(source, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    saved = build.bind
    build.bind = bind
    try:
        yield
    finally:
        build.bind = saved


@contextlib.contextmanager
def split_keys(p: int):
    saved = fa.PAGED_SPLIT_KEYS
    fa.PAGED_SPLIT_KEYS = p
    try:
        yield
    finally:
        fa.PAGED_SPLIT_KEYS = saved


def lens_case(q, pairs, lens_list, seed):
    """Tables for other lengths over phase 3's pools (distinct pages)."""
    mb = chip_smoke.MODEL["max_context"] // chip_smoke.BLOCK
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(chip_smoke.POOL_BLOCKS - 1, generator=gen) + 1
    tables = torch.zeros(len(lens_list), mb, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens_list):
        need = -(-n // chip_smoke.BLOCK)
        tables[i, :need] = perm[used:used + need]
        used += need
    return (q, pairs, tables.cuda(),
            torch.tensor(lens_list, dtype=torch.int32).cuda())


def launches_of(mod, q, pairs, tables, lens):
    """The (entry point, arguments) that one wrapper call per pool pair
    hands to its build.launch, and the outputs, kept alive."""
    seen, outs = [], []
    saved = mod.build.launch

    def record(name, fn, *args):
        seen.append((fn, args))
        saved(name, fn, *args)

    mod.build.launch = record
    try:
        for k, v in pairs:
            outs.append(mod.paged_decode_attention(q, k, v, tables, lens))
    finally:
        mod.build.launch = saved
    return seen, outs


def timed(mod, q, pairs, tables, lens):
    """{"event": back-to-back ms a call on one pool pair, "event6": ms a
    call over the pool pairs in turn (CUDA events around wrapper calls),
    "raw", "raw6": the same around the entry point's launches alone, the
    wrapper's Python left out, "device", "device6": the profiler's device
    time (None where its profiles lost kernel events)}. The wrapper's
    event times hold its host time a call where that exceeds the
    kernel's."""
    kp, vp = pairs[0]

    def one():
        mod.paged_decode_attention(q, kp, vp, tables, lens)

    def six():
        for k, v in pairs:
            mod.paged_decode_attention(q, k, v, tables, lens)

    seen, outs = launches_of(mod, q, pairs, tables, lens)
    fn, args = seen[0]

    def raw6():
        for f, a in seen:
            f(*a)

    dev1 = chip_smoke.device_host(torch, one, 20, 1)[0]
    dev6 = chip_smoke.device_host(torch, six, 10, 1)[0]
    got = {"event": chip_smoke.cuda_ms(torch, one, 50),
           "event6": chip_smoke.cuda_ms(torch, six, 10) / len(pairs),
           "raw": chip_smoke.cuda_ms(torch, lambda: fn(*args), 50),
           "raw6": chip_smoke.cuda_ms(torch, raw6, 10) / len(pairs),
           "device": dev1,
           "device6": None if dev6 is None else dev6 / len(pairs)}
    del outs
    return got


def raw_ms(q, pairs, tables, lens):
    """(ms a launch back to back on one pool pair, ms a launch over the
    pool pairs in turn): this tree's wrapper's launches replayed alone,
    by CUDA events."""
    seen, outs = launches_of(fa, q, pairs, tables, lens)
    fn, args = seen[0]

    def six():
        for f, a in seen:
            f(*a)

    got = (chip_smoke.cuda_ms(torch, lambda: fn(*args), 50),
           chip_smoke.cuda_ms(torch, six, 10) / len(seen))
    del outs
    return got


def mean_of(rows, key):
    vals = [r[key] for r in rows]
    return None if None in vals else sum(vals) / len(vals)


def ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def host_pieces(q, pairs, tables, lens, n=200):
    """Host us a call of each piece of the wrapper, each repeated n times
    with no sync: its five checks, the output's allocation, the device
    guard and stream, the scratch lookup, the cached bind lookup, the
    ctypes launch alone; then the whole call."""
    import time
    kp, vp = pairs[0]
    s_n, h, d = q.shape
    mb = tables.shape[1]
    p, n_split = fa.paged_split_plan(mb * kp.shape[1])
    stream = build.stream(q.device)
    tickets, part = fa._paged_scratch_of(q.device, stream, s_n * h,
                                         s_n * h * n_split * (d + 2))
    argtypes = (fa._P,) * 8 + (fa._I,) * 7 + (fa._F, fa._P)
    fn = build.bind("paged_attention.cu", "paged_decode_attention_f32",
                    argtypes)
    out = torch.empty_like(q)
    launch_args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                   tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                   tickets, part, s_n, h, d, kp.shape[0], kp.shape[1], mb,
                   p, 1.0 / 16, stream)

    def checks():
        fa._check_cuda("q", q, q.device, torch.float32, 3)
        fa._check_cuda("k_pool", kp, q.device, torch.float32, 4)
        fa._check_cuda("v_pool", vp, q.device, torch.float32, 4)
        fa._check_cuda("block_tables", tables, q.device, torch.int32, 2)
        fa._check_cuda("context_lens", lens, q.device, torch.int32, 1)

    def guard():
        with build.device_guard(q.device):
            build.stream(q.device)

    pieces = {
        "checks": checks,
        "allocation": lambda: torch.empty_like(q),
        "device guard and stream": guard,
        "scratch": lambda: fa._paged_scratch_of(
            q.device, stream, s_n * h, s_n * h * n_split * (d + 2)),
        "bind lookup": lambda: build.bind(
            "paged_attention.cu", "paged_decode_attention_f32", argtypes),
        "ctypes launch": lambda: fn(*launch_args),
        "whole call": lambda: fa.paged_decode_attention(q, kp, vp, tables,
                                                        lens),
    }
    got = {}
    for name, f in pieces.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        got[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return got


def check(mod, q, pairs, tables, lens):
    kp, vp = pairs[0]
    out = mod.paged_decode_attention(q, kp, vp, tables, lens)
    again = mod.paged_decode_attention(q, kp, vp, tables, lens)
    want = fa.paged_attention_reference(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    share = chip_smoke.limit_share(torch, out, want, TOL, TOL)
    idle = [i for i, n in enumerate(lens.tolist()) if n == 0]
    if share > 1 or not all(bool((out[i] == 0).all()) for i in idle):
        raise RuntimeError(f"{mod.__name__}: outside the 1e-5 limit "
                           f"({share:.3f} of it) or an idle slot not zero")
    return out, share, torch.equal(out, again)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--also", type=Path, action="append", default=[],
                    help="another tree, timed in the same turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_decode_probe: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}")
    report = build.build([SOURCE])
    for line in registers(report.get(SOURCE, {}).get("log", "")):
        print(f"  ptxas, this tree: {line}")
    parent = None
    if args.parent is not None:
        parent = parent_module(args.parent.resolve())
        plog = parent.build.build(["paged_attention.cu"])
        for line in registers(plog.get("paged_attention.cu", {})
                              .get("log", "")):
            print(f"  ptxas, parent: {line}")

    q, pairs, tables, lens = chip_smoke.paged_case(
        torch, pools=chip_smoke.PAGED_POOLS)
    nbytes = chip_smoke.paged_bytes(q, tables, lens)
    bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    print(f"shape: slots {list(chip_smoke.PAGED_LENS)}, H {q.shape[1]}, D "
          f"{q.shape[2]}, BS {chip_smoke.BLOCK}, {nbytes / 1e6:.1f} MB a "
          f"call, bytes bound {bound:.4f} ms; P {fa.PAGED_SPLIT_KEYS}, "
          f"{fa.paged_split_plan(tables.shape[1] * chip_smoke.BLOCK)[1]} "
          f"splits a (slot, head)")

    mods = {"this tree": fa}
    if parent is not None:
        mods["parent"] = parent
    for i, other in enumerate(args.also):
        mods[str(other)] = parent_module(other.resolve(), f"_also{i}")
        mods[str(other)].build.build(["paged_attention.cu"])
    outs = {}
    for name, mod in mods.items():
        out, share, same = check(mod, q, pairs, tables, lens)
        outs[name] = out
        dev, launches, host = chip_smoke.device_host(
            torch, lambda mod=mod: mod.paged_decode_attention(
                q, *pairs[0], tables, lens))
        dev_s = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"{name}: {share:.4f} of the 1e-5 limit, two calls the same "
              f"bits {same}; device {dev_s} and {launches} CUDA launch(es) "
              f"a call (profiler); host {host:.1f} us a call (200 queued) "
              f"[{card}]")
    for name in mods:
        if name == "this tree":
            continue
        share = chip_smoke.limit_share(torch, outs["this tree"], outs[name],
                                       TOL, TOL)
        print(f"this tree against {name}: {share:.4f} of the 1e-5 limit")
        if share > 1:
            raise RuntimeError(f"this tree's kernel and {name}'s differ")
    order = list(mods) + list(mods)[::-1]
    got = {k: [] for k in mods}
    for name in order:
        got[name].append(timed(mods[name], q, pairs, tables, lens))
    for name, rows in got.items():
        m = {k: mean_of(rows, k) for k in rows[0]}
        dev, dev6 = m["device"], m["device6"]
        rates = "" if dev is None or dev6 is None else (
            f"; device {nbytes / dev / 1e9:.3f} TB/s "
            f"({nbytes / dev6 / 1e9:.3f} over the pools), "
            f"{bound / dev:.3f} of the bytes bound ({bound / dev6:.3f})")
        print(f"in turns, {name}: device {ms(dev)} ms a call "
              f"({[ms(r['device']) for r in rows]}), {ms(dev6)} over "
              f"{len(pairs)} pool pairs in turn; launches alone back to "
              f"back {m['raw']:.4f} ms ({[round(r['raw'], 4) for r in rows]}"
              f"), {m['raw6']:.4f} over the pools, "
              f"{nbytes / m['raw'] / 1e9:.3f} TB/s ("
              f"{nbytes / m['raw6'] / 1e9:.3f}); wrapper calls back to back "
              f"{m['event']:.4f} ms ({[round(r['event'], 4) for r in rows]}),"
              f" {m['event6']:.4f} over the pools" + rates + f" [{card}]")
    pieces = host_pieces(q, pairs, tables, lens)
    print("host us a call by piece (200 each, no sync): " + "; ".join(
        f"{k} {v:.1f}" for k, v in pieces.items()) + f" [{card}]")

    cases = {"phase 3's lengths": list(chip_smoke.PAGED_LENS),
             "every slot at 1024": [1024] * chip_smoke.SLOTS,
             "every slot at 128": [128] * chip_smoke.SLOTS}
    for label, lens_list in cases.items():
        cq, cp, ct, cl = lens_case(q, pairs, lens_list, 7)
        nb = chip_smoke.paged_bytes(cq, ct, cl)
        cells = []
        for p in SPLITS:
            with split_keys(p):
                _, share, same = check(fa, cq, cp, ct, cl)
                r = timed(fa, cq, cp, ct, cl)
            cells.append(f"P {p}: {ms(r['device'])} / {ms(r['device6'])} / "
                         f"{r['raw']:.4f} / {r['raw6']:.4f} ms ("
                         f"{nb / r['raw6'] / 1e9:.3f} TB/s)"
                         + ("" if same else ", two calls differ"))
        print(f"P sweep, {label} ({nb / 1e6:.1f} MB), ms a call: device on "
              f"one pool pair / over the pools (profiler) / launches alone "
              f"on one / over the pools (events): " + "; ".join(cells)
              + f" [{card}]")

    libs, logs = compile_variants(build.BUILD_DIR / "paged_probe")
    for name, log in logs.items():
        for line in registers(log):
            print(f"  ptxas, {name}: {line}")
    base = "as it is"
    full = lens_case(q, pairs, [1024] * chip_smoke.SLOTS, 7)
    for name, lib in libs.items():
        if name == base:
            continue
        rows = {base: [], name: []}
        for turn in (base, name, name, base):
            with library(libs[turn]):
                if turn == name and not rows[name] and name in CORRECT:
                    check(fa, q, pairs, tables, lens)
                rows[turn].append((raw_ms(q, pairs, tables, lens),
                                   raw_ms(*full)))
        b, v = ([sum(r[i][j] for r in rows[k]) / 2 for i in (0, 1)
                 for j in (0, 1)] for k in (base, name))
        print(f"variant {name}: {' / '.join(f'{x:.4f}' for x in v)} ms a "
              f"call (launches alone, by events: on one pool pair / over "
              f"the pools at phase 3's lengths, the same with every slot at "
              f"1024) against the source as it is "
              f"{' / '.join(f'{x:.4f}' for x in b)}, in turns [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
