"""Where the time of the port's LSTM forward goes, on one GPU.

At chip_smoke.py's bench shape (T 100, B 64, H 512), full length and
ragged (``check_lstm``'s lengths), at the card-vs-CPU width (T 100, B
8, H 128) and at twice the bench batch (T 100, B 128, H 512: two row
tiles a block), for the wrapper ``fused_lstm.lstm_seq_fwd`` (the sequence
kernel under the plan it takes), for the step kernel of this tree (T
launches, the forward of the shapes no plan takes) and, with ``--parent
DIR`` (DIR holds another tree, e.g. the parent unpacked by ``git
archive``), for that tree's wrapper, imported with its own ``build.py``
as a package of its own, in turns (parent, this, this, parent):

* device ms a call and CUDA launches a call (``torch.profiler``);
* us a step (the device time over T);
* the back-to-back event time that ``chip_smoke.cuda_ms`` reports;
* TFLOP/s of the products the data needs (the rows a sequence reaches)
  and the share of the f32 bound (67 TFLOP/s) and of the 3xTF32 bound
  (three TF32 products at 495 TFLOP/s), each the larger of its
  operations and the bytes over 3.35 TB/s;
* ``torch.nn.LSTM``'s forward (cuDNN, TF32 off; it also computes the
  input projection) beside them.

Then builds of ``fused_lstm.cu`` that drop parts of the sequence
kernel's step, called through the entry point at the wrapper's plan,
device ms a call and us a step: ``barriers only``
(no r loads, product or cell: a step is its partial-sum stores, two
__syncthreads and the grid barrier), ``+ r loads`` (the copies of
r_{t-1} from L2 land), ``+ product`` (the 3xTF32 product, no cell), and
the whole kernel. The differences split a step into barrier, r loads,
product and cell. ptxas' registers and spills of the sequence kernel,
and its HMMA and FFMA counts, are printed. Every
wrapper call is first held against ``lstm_seq_fwd_reference`` (atol =
rtol = 1e-5), two calls bit for bit.

Run from the repository root on a machine with the CUDA toolkit:
``python scripts/torch_lstm_fwd_probe.py [--parent DIR]``.
"""

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import torch_chain_ab as ab  # noqa: E402
from paddle_tpu_torch.kernels import build  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as fl  # noqa: E402

SOURCE = "fused_lstm.cu"
TOL = 1e-5
LOAD = ("        load_r(mine, rp, vec, row0, rows, B, H, k0, kb, stride, "
        "lane);\n")
PRODUCT = "        product(acc, mine, wf, mt, kb, stride, g, tq);\n"
CELL = ("      if (col_ok && b < B) {\n        // the partial sums in warp",
        "      if (false) {\n        // the partial sums in warp")
VARIANTS = {
    "barriers only": ((LOAD, ""), (PRODUCT, ""), CELL),
    "+ r loads": ((PRODUCT, ""), CELL),
    "+ product": (CELL,),
    "whole": (),
}


def parent_module(parent: Path, package: str = "_parent_kernels"):
    """The other tree's kernels/fused_lstm.py, imported with its own
    build.py as the package `package`."""
    pkg = types.ModuleType(package)
    pkg.__path__ = [str(parent / "paddle_tpu_torch" / "kernels")]
    sys.modules[package] = pkg
    return importlib.import_module(f"{package}.fused_lstm")


def compile_variants(out_dir: Path):
    """({name: library}, {name: ptxas log}) of builds of fused_lstm.cu
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
        (vdir / "tf32_mma.cuh").write_text(
            (build.CSRC / "tf32_mma.cuh").read_text())
        lib = vdir / "fused_lstm.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(vdir / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name], logs[name] = lib, log
    return libs, logs


def registers(log: str) -> list:
    """ptxas' stack, spills and registers of the sequence kernel."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if "lstm_fwd_seq_kernel" in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def instructions(lib: Path) -> list:
    return [f"{name}: {text.count('HMMA')} HMMA, {text.count('FFMA')} FFMA"
            for name, text in sorted(ab.sass(lib).items())
            if "lstm_fwd_seq_kernel" in name]


def entry(lib: Path):
    fn = getattr(ctypes.CDLL(str(lib)), fl._SEQ[0])
    fn.argtypes = list(fl._SEQ[1])
    fn.restype = ctypes.c_int
    return fn


def case(t, b, h, ragged, seed):
    """chip_smoke.lstm_case's forward inputs; ragged: check_lstm's
    lengths (1 and T among them)."""
    lens = None
    if ragged:
        rng = np.random.default_rng(seed + 11)
        lens = rng.integers(1, t + 1, b)
        lens[:2] = (1, t)
        lens = lens.tolist()
    d = chip_smoke.lstm_case(torch, t, b, h, lens, seed + 12)
    live = t * b if lens is None else int(sum(lens))
    return [d[k] for k in ("x", "w", "b", "mask", "r0", "c0")], live


def measure(fn):
    """(device ms a call, launches a call, event ms); device ms None where
    the profiles lost kernel events."""
    dev, launches, _ = chip_smoke.device_host(torch, fn)
    return dev, launches, chip_smoke.cuda_ms(torch, fn, 20)


def line(name, m, t, prod, nbytes):
    dev, launches, ev = m
    f32 = chip_smoke.bound_ms(nbytes, prod)[0]
    tf32 = chip_smoke.bound_ms(nbytes, 3 * prod, chip_smoke.TF32_FLOPS_PER_S)[0]
    if dev is None:
        return (f"  {name}: device not measured, event {ev:.4f} ms")
    return (f"  {name}: device {dev:.4f} ms a call, {launches} launches a "
            f"call, {1e3 * dev / t:.3f} us a step, event {ev:.4f} ms; "
            f"{prod / dev / 1e9:.2f} TFLOP/s; share of the f32 bound "
            f"{f32 / dev:.3f}, of the 3xTF32 bound {tf32 / dev:.3f}")


def check(mod, args):
    rs, cs = mod.lstm_seq_fwd(*args)
    again = mod.lstm_seq_fwd(*args)
    want = fl.lstm_seq_fwd_reference(*args)
    torch.cuda.synchronize()
    share = max(float(((g - w).abs() / (TOL + TOL * w.abs())).max())
                for g, w in zip((rs, cs), want))
    if share > 1:
        raise RuntimeError(f"{mod.__name__}: outside the 1e-5 limit "
                           f"({share:.3f} of it)")
    if not all(torch.equal(x, y) for x, y in zip((rs, cs), again)):
        raise RuntimeError(f"{mod.__name__}: two calls differ")
    return share


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lstm_fwd_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}")
    build.build([SOURCE])
    parent = parent_module(args.parent) if args.parent else None
    if parent is not None:
        parent.build.build([SOURCE])
    libs, logs = compile_variants(build.BUILD_DIR / "lstm_fwd_probe")
    for reg in registers(logs["whole"]):
        print(f"ptxas {reg}")
    for ins in instructions(libs["whole"]):
        print(f"sass {ins}")
    fns = {name: entry(lib) for name, lib in libs.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    steps = fl._fn(*fl._STEPS)
    for t, b, h, ragged in ((100, 64, 512, False), (100, 64, 512, True),
                            (100, 8, 128, False), (100, 128, 512, False)):
        fwd, live = case(t, b, h, ragged, args.seed)
        prod = 2 * live * h * 4 * h
        nbytes = 4 * (t * b * 4 * h + h * 4 * h + 4 * h + t * b + 2 * b * h
                      + 2 * t * b * h)
        plan = fl._plan_of(b, h, dev.index)
        shares = {"this tree": check(fl, fwd)}
        if parent is not None:
            shares["parent"] = check(parent, fwd)
        print(f"T {t}, B {b}, H {h}, {'ragged' if ragged else 'full length'}"
              f" ({live} live rows): plan {plan}; largest share of the 1e-5 "
              f"limit {', '.join(f'{k} {v:.4f}' for k, v in shares.items())}"
              f" [{card}]")
        ptrs = [v.data_ptr() for v in fwd]
        rs = torch.empty(t, b, h, device=dev)
        cs = torch.empty_like(rs)
        stream = build.stream(dev)

        def step_kernel():
            build.launch("steps", steps, *ptrs, rs.data_ptr(),
                         cs.data_ptr(), t, b, h, stream)

        calls = {"this tree": lambda: fl.lstm_seq_fwd(*fwd),
                 "step kernel (this tree)": step_kernel}
        order = list(calls)
        if parent is not None:
            calls["parent"] = lambda: parent.lstm_seq_fwd(*fwd)
            order = ["parent", "this tree", "this tree", "parent",
                     "step kernel (this tree)"]
        got = {}
        for name in order:
            got.setdefault(name, []).append(measure(calls[name]))
        for name, ms in got.items():
            mean = tuple(None if None in col else sum(col) / len(col)
                         for col in zip(*ms))
            print(line(name, mean, t, prod, nbytes))
            if len(ms) > 1:
                print(f"    in turns: device "
                      f"{[None if m[0] is None else round(m[0], 4) for m in ms]}"
                      f" ms")
        lstm = torch.nn.LSTM(h, h).cuda()
        inp = fwd[0][:, :, :h].contiguous()
        h0 = (fwd[4][None].contiguous(), fwd[5][None].contiguous())
        with torch.no_grad():
            print(line("nn.LSTM forward",
                       measure(lambda: lstm(inp, h0)), t, prod, nbytes))
        del lstm
        barrier = fl._barrier_of(dev, stream)
        split = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                build.launch(name, fn, *ptrs, rs.data_ptr(), cs.data_ptr(),
                             barrier, t, b, h, plan.mt, plan.kb, plan.nt,
                             stream)
            split[name] = measure(call)
            print(line(f"{name} build", split[name], t, prod, nbytes))
        us = [None if split[n][0] is None else 1e3 * split[n][0] / t
              for n in VARIANTS]
        if None not in us:
            print(f"  a step: barrier {us[0]:.3f} us, r loads "
                  f"{us[1] - us[0]:.3f} us, product {us[2] - us[1]:.3f} us,"
                  f" cell {us[3] - us[2]:.3f} us")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
