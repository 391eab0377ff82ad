"""Where the time of the port's conv-epilogue kernels goes, on one GPU:
host and device apart.

At each of ResNet-50's epilogue shapes at batch 128 (the fused training
program's ``fused_conv2d`` ops, ``chip_smoke.epilogue_ops``), for the
wrappers ``fused_conv.channel_stats``, ``apply_epilogue`` (with the op's
ReLU) and ``apply_epilogue_add`` (ReLU), and for their yardsticks
``torch.var_mean`` and ``F.batch_norm`` (training mode, stats + apply):

* device ms a launch and launches a call (``torch.profiler``);
* host us a call: a host clock around 200 calls queued with no sync;
* the back-to-back event time that ``chip_smoke.cuda_ms`` reports;
* TB/s (each input read once, each output written once) and the share of
  the bytes bound (3.35 TB/s).

With ``--parent DIR`` (DIR holds another tree, e.g. the parent unpacked
by ``git archive``), that tree's ``kernels/fused_conv.py`` and its own
``build.py`` are imported as a package of their own (its kernels built
from its ``csrc`` into its ``_build``) and measured the same way, in
turns with this tree's (parent, this, this, parent); apply's outputs are
held bit for bit against the parent's, and the stats within 1e-5 of
their terms' sums. Every call is first held against the plain versions
(stats within 1e-5 of their terms, apply within atol = rtol = 1e-5), and
two stats calls on one input against each other, bit for bit.

Then the designs the wrappers choose between, device time a launch by
the profiler, the kernels called through their entry points: the stats
kernel at every column width (lanes 32 to 256, 4 * lanes floats a
column range) and at the chosen row slicing and twice it; the apply
kernel at every width and 4, 8 or 16 rows a thread; builds of
``fused_conv.cu`` with twice the rows in flight a thread (16 for the
stats, 8 for apply) and with the 16-byte loads asking L2 for 256 bytes
(``ld.global.nc.L1::no_allocate.L2::256B``), and the stats kernel's
reads and adds alone (no block reduction, partials or ticket), in turns
with the kernel.
At [128, 256, 14, 14], the host us a call of each piece of the
wrappers (allocation, views, checks, plan, device guard and stream,
scratch, the cached ``build.bind`` lookup, the ctypes launch) beside a
whole call. A device time whose profiles lost kernel events is printed
as not measured. Last, the host cost
of ``FusedConvEpilogue.forward``'s affine fold (the statistics into
scale and shift, and the running statistics: ops on [C] vectors) at
each C.

Run from the repository root on a machine with the CUDA toolkit:
``python scripts/torch_fused_conv_probe.py [--parent DIR]``.
"""

import argparse
import ctypes
import importlib
import subprocess
import sys
import time
import types
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_conv as fc  # noqa: E402


def parent_module(parent: Path):
    """The other tree's kernels/fused_conv.py, imported with its own
    build.py as the package _parent_kernels."""
    pkg = types.ModuleType("_parent_kernels")
    pkg.__path__ = [str(parent / "paddle_tpu_torch" / "kernels")]
    sys.modules["_parent_kernels"] = pkg
    return importlib.import_module("_parent_kernels.fused_conv")


def calls(mod, a, sc, sh, d, relu):
    return {"stats": lambda: mod.channel_stats(a),
            "apply": lambda: mod.apply_epilogue(a, sc, sh, relu),
            "add": lambda: mod.apply_epilogue_add(a, sc, sh, d, True)}


def measure(fn):
    """(device ms a launch, launches a call, host us a call, event ms);
    the first two None where the profiles lost kernel events."""
    dev, launches, host = chip_smoke.device_host(torch, fn)
    return (None if dev is None else dev / max(launches, 1), launches, host,
            chip_smoke.cuda_ms(torch, fn, 20))


def mean(rows):
    """Column means of rows; None for a column that holds a None."""
    cols = list(zip(*rows))
    return tuple(None if None in col else sum(col) / len(col)
                 for col in cols)


def ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def stats_share(got, want, a):
    terms = (a.abs().sum(dim=(0, 2)), (a * a).sum(dim=(0, 2)))
    return max(float(((g - w).abs() / (1e-5 * m)).max())
               for g, w, m in zip(got, want, terms))


def check(a, sc, sh, d, relu, parent):
    """Largest shares of the limits against the plain versions (and the
    parent); raises where a limit or a bit-for-bit check fails."""
    got = fc.channel_stats(a)
    again = fc.channel_stats(a)
    share = {"stats": stats_share(got, fc.channel_stats_reference(a), a)}
    ys = {"apply": fc.apply_epilogue(a, sc, sh, relu),
          "add": fc.apply_epilogue_add(a, sc, sh, d, True)}
    refs = {"apply": fc.apply_epilogue_reference(a, sc, sh, None, relu),
            "add": fc.apply_epilogue_reference(a, sc, sh, d, True)}
    for k, y in ys.items():
        share[k] = chip_smoke.limit_share(torch, y, refs[k], 1e-5, 1e-5)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError("two stats calls on one input differ")
    if max(share.values()) > 1:
        raise RuntimeError(f"a kernel misses its limit: {share}")
    if parent is None:
        return share, None
    same = {"apply": torch.equal(ys["apply"],
                                 parent.apply_epilogue(a, sc, sh, relu)),
            "add": torch.equal(ys["add"], parent.apply_epilogue_add(
                a, sc, sh, d, True)),
            "stats": stats_share(got, parent.channel_stats(a), a)}
    if not (same["apply"] and same["add"] and same["stats"] <= 1):
        raise RuntimeError(f"this tree's kernels against the parent's: "
                           f"{same}")
    return share, same


def kernel_ms(fn):
    dev, launches, _ = chip_smoke.device_host(torch, fn, queued=1)
    return None if dev is None else dev / max(launches, 1)


def designs(a, sc, sh, relu):
    """Device ms a launch of the kernels at other plans than the
    wrappers'."""
    n, c, s = a.shape
    stream = build.stream(a.device)
    sms = build.sm_count(a.device)
    widths = (32, 64, 128, 256) if c * s % 4 == 0 else (32,)
    chosen = fc._stats_plan(n, c, s, sms)
    stats_fn, apply_fn = fc._fn(fc._STATS), fc._fn(fc._APPLY)
    out = {"stats": {}, "apply": {}}
    res = torch.empty(2, c, device=a.device)
    for lanes in widths:
        ranges = -(-c * s // (4 * lanes))
        rule = -(-n // chosen[1])
        for parts in sorted({rule, min(2 * rule, n)}):
            rows = -(-n // parts)
            partials = -(-n // rows) * (ranges + c)
            tickets, part = fc._scratch_of(a.device, stream, c, partials)

            def stats(rows=rows, partials=partials, lanes=lanes,
                      tickets=tickets, part=part):
                err = stats_fn(a.data_ptr(), res.data_ptr(), tickets, part,
                               n, c, s, lanes, rows, partials, stream)
                if err:
                    raise RuntimeError(f"stats plan refused: {err}")
            out["stats"][(lanes, parts)] = kernel_ms(stats)
        y = torch.empty_like(a)
        for per in (4, 8, 16):
            rows = per * (256 // lanes)

            def apply(rows=rows, lanes=lanes):
                err = apply_fn(a.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                               y.data_ptr(), n, c, s, int(relu), lanes, rows,
                               stream)
                if err:
                    raise RuntimeError(f"apply plan refused: {err}")
            out["apply"][(lanes, per)] = kernel_ms(apply)
    return out, chosen, fc._apply_plan(n, c, s, sms)


L2_LOAD = """__device__ __forceinline__ float4 load4(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 "
               "{%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}"""
VARIANTS = {
    "16 / 8 rows in flight": (
        ("constexpr int kStatsRows = 8;", "constexpr int kStatsRows = 16;"),
        ("constexpr int kApplyRows = 4;", "constexpr int kApplyRows = 8;")),
    "L2 256-byte prefetch": (
        ("__device__ __forceinline__ float4 load4(const float4* p) "
         "{ return __ldg(p); }", L2_LOAD),),
    # the stats kernel's reads and adds alone: no block reduction, no
    # partials, no ticket (its sums are wrong; apply is the kernel's)
    "stats' loads alone": (
        ("  // the R row groups' column sums, added in order into row "
         "group 0's\n",
         "  if (s1[0] + s2[1] + s1[2] + s2[3] == -1.f) out[0] = s1[1];\n"
         "  return;\n"),),
}


def compile_variants(out_dir: Path) -> dict:
    """{name: [stats entry, apply entry]} of builds of fused_conv.cu with
    VARIANTS' substitutions, built in parallel."""
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        text = (build.CSRC / "fused_conv.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: fused_conv.cu has no {old!r}")
            text = text.replace(old, new)
        (vdir / "fused_conv.cu").write_text(text)
        (vdir / "common.cuh").write_text(
            (build.CSRC / "common.cuh").read_text())
        lib = vdir / "fused_conv.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(vdir / "fused_conv.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        fns[name] = []
        for symbol, argtypes in (fc._STATS, fc._APPLY):
            f = getattr(dll, symbol)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            fns[name].append(f)
    return fns


def variant_ms(a, sc, sh, relu, variants):
    """Device ms a launch of the kernels and of each variant at the
    wrappers' plans (kernel, variants, kernel)."""
    n, c, s = a.shape
    stream = build.stream(a.device)
    (lanes, rows, partials), (alanes, arows) = fc._plans(n, c, s,
                                                        a.device.index)
    tickets, part = fc._scratch_of(a.device, stream, c, partials)
    res, y = torch.empty(2, c, device=a.device), torch.empty_like(a)
    entries = ([("kernel", (fc._fn(fc._STATS), fc._fn(fc._APPLY)))]
               + list(variants.items()))
    out = {}
    for name, (stats, apply) in entries + entries[:1]:
        got = (kernel_ms(lambda: stats(a.data_ptr(), res.data_ptr(), tickets,
                                       part, n, c, s, lanes, rows, partials,
                                       stream)),
               kernel_ms(lambda: apply(a.data_ptr(), sc.data_ptr(),
                                       sh.data_ptr(), y.data_ptr(), n, c, s,
                                       int(relu), alanes, arows, stream)))
        out.setdefault(name, []).append(got)
    return {k: mean(v) for k, v in out.items()}


def host_us(fn, k=200):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    host = (time.perf_counter() - t0) / k * 1e6
    torch.cuda.synchronize()
    return host


def host_parts(a, sc, sh):
    """Host us a call of the pieces of the stats and apply wrappers."""
    n, c, s = a.shape
    dev = a.device
    lanes, rows, partials = fc._plans(n, c, s, dev.index)[0]
    out = torch.empty((2, c), device=dev)
    stream = build.stream(dev)
    tickets, part = fc._scratch_of(dev, stream, c, partials)
    stats_fn = fc._fn(fc._STATS)

    def guard():
        with build.device_guard(dev):
            build.stream(dev)
    return {
        "a.new_empty [2, C]": host_us(lambda: a.new_empty((2, c))),
        "torch.empty [2, C] (dtype, device)": host_us(lambda: torch.empty(
            (2, c), dtype=torch.float32, device=dev)),
        "unbind": host_us(lambda: out.unbind(0)),
        "torch.empty_like(a)": host_us(lambda: torch.empty_like(a)),
        "a's checks": host_us(lambda: build.check("a", a, dev, (n, c, s),
                                                  aligned=True)),
        "plan lookup": host_us(lambda: fc._plans(n, c, s, dev.index)),
        "device guard + stream": host_us(guard),
        "scratch lookup": host_us(lambda: fc._scratch_of(dev, stream, c,
                                                         partials)),
        "build.bind lookup (cached)": host_us(lambda: fc._fn(fc._STATS)),
        "stats launch (ctypes)": host_us(lambda: stats_fn(
            a.data_ptr(), out.data_ptr(), tickets, part, n, c, s, lanes,
            rows, partials, stream)),
        "channel_stats": host_us(lambda: fc.channel_stats(a)),
        "apply_epilogue": host_us(lambda: fc.apply_epilogue(a, sc, sh)),
        "an empty Python call": host_us(lambda: None, 2000),
    }


def fold_host_us(c):
    """Host us a call of FusedConvEpilogue.forward's ops on [C]."""
    ssum = torch.rand(c, device="cuda")
    ssq = ssum + 1
    scale, bias, rm, rv = (torch.rand(c, device="cuda") for _ in range(4))

    def fold():
        mean = ssum / 1000
        var = torch.clamp_min(ssq / 1000 - mean * mean, 0.0)
        inv = torch.rsqrt(var + 1e-5)
        scale_c = scale.float() * inv
        shift_c = bias.float() - mean * scale_c
        return shift_c, 0.9 * rm + 0.1 * mean, 0.9 * rv + 0.1 * var
    return chip_smoke.device_host(torch, fold)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    for src, r in build.build(["fused_conv.cu"]).items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"{src}: {line.strip()}")
    parent = None
    if args.parent is not None:
        parent = parent_module(args.parent.resolve())
        parent.build.build(["fused_conv.cu"])
    variants = compile_variants(build.BUILD_DIR / "fused_conv_probe")
    ops = chip_smoke.epilogue_ops(chip_smoke.build_resnet50(pt, 0)["fused"],
                                  chip_smoke.RESNET["batch"])
    relu_of = {}
    for shape, relu, add in ops:
        if not add:
            relu_of.setdefault(shape, relu)
    gen = torch.Generator(device="cuda").manual_seed(19)
    for shape in dict.fromkeys(sh for sh, _, _ in ops):
        n, c, h, w = shape
        s, elems = h * w, n * c * h * w
        a = torch.randn(n, c, s, device="cuda", generator=gen) + 0.5
        d = torch.randn(n, c, s, device="cuda", generator=gen)
        gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        sc, sh = gamma * 0.9, beta - 0.2
        relu = relu_of.get(shape, True)
        share, same = check(a, sc, sh, d, relu, parent)
        nbytes = {"stats": 4 * elems + 8 * c, "apply": 8 * elems + 8 * c,
                  "add": 12 * elems + 8 * c}
        impls = {"this": calls(fc, a, sc, sh, d, relu)}
        if parent is not None:
            impls["parent"] = calls(parent, a, sc, sh, d, relu)
        order = (["parent", "this", "this", "parent"] if parent is not None
                 else ["this", "this"])
        got = {k: {name: [] for name in impls} for k in nbytes}
        for name in order:
            for k, fn in impls[name].items():
                got[k][name].append(measure(fn))
        a4 = a.view(n, c, h, w)
        lib = {"var_mean": measure(lambda: torch.var_mean(a, dim=(0, 2))),
               "F.batch_norm": measure(lambda: F.batch_norm(
                   a4, None, None, gamma, beta, True, 0.1, 1e-5))}
        print(f"conv epilogue {list(shape)}, relu {relu} "
              f"[{card}]", flush=True)
        for k, by in got.items():
            bound = nbytes[k] / chip_smoke.HBM_BYTES_PER_S * 1e3
            for name, rows in by.items():
                dev, launches, host, event = mean(rows)
                rate = ("device not measured" if dev is None else
                        f"device {dev:.4f} ms a launch x {launches:g} "
                        f"launches, {nbytes[k] / (dev * launches) / 1e9:.3f}"
                        f" TB/s, {bound / (dev * launches):.3f} of the bound")
                print(f"  {k} {name}: {rate}; bound {bound:.4f} ms; host "
                      f"{host:.1f} us a call; events {event:.4f} ms a call",
                      flush=True)
        for name, (dev, launches, host, event) in lib.items():
            print(f"  {name}: device {ms(dev)} ms a launch x {launches} "
                  f"launches; host {host:.1f} us a call; events "
                  f"{event:.4f} ms a call", flush=True)
        print(f"  largest shares of the limits: " + ", ".join(
            f"{k} {v:.4f}" for k, v in share.items())
            + ("" if same is None else
               f"; against the parent: apply the same bits {same['apply']}"
               f", apply + add {same['add']}, stats' share "
               f"{same['stats']:.4f}"), flush=True)
        plans, stats_plan, apply_plan = designs(a, sc, sh, relu)
        print(f"  stats plans (lanes, slices) -> device ms, chosen lanes "
              f"{stats_plan[0]}, {-(-n // stats_plan[1])} slice(s): "
              + ", ".join(f"{k}: {ms(v)}" for k, v in plans["stats"].items()),
              flush=True)
        print(f"  apply plans (lanes, rows a thread) -> device ms, chosen "
              f"lanes {apply_plan[0]}, {apply_plan[1] * apply_plan[0] // 256}"
              f" rows a thread: " + ", ".join(
                  f"{k}: {ms(v)}" for k, v in plans["apply"].items()),
              flush=True)
        print("  device ms a launch, stats / apply, at the wrappers' plans: "
              + "; ".join(f"{k} {ms(v[0])} / {ms(v[1])}" for k, v in
                          variant_ms(a, sc, sh, relu, variants).items()),
              flush=True)
        if shape == (128, 256, 14, 14):
            print("  host us a call: " + "; ".join(
                f"{k} {v:.1f}" for k, v in host_parts(a, sc, sh).items()),
                flush=True)
        del a, d, a4
    for c in sorted({sh[1] for sh, _, _ in ops}):
        dev, launches, host = fold_host_us(c)
        print(f"affine fold at C {c}: host {host:.1f} us a call, device "
              f"{ms(dev)} ms in {launches} launches [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
