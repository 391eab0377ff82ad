"""Host profile of the decode bundle's prefill at full width, for one tree.

    python scripts/torch_prefill_host_profile.py [--tree DIR] [--calls N]
        [--bound B] [--seed N] [--cpu]

Imports ``paddle_tpu_torch`` from DIR (default: this repository; e.g. a
parent commit unpacked by ``git archive`` into a git-ignored directory),
exports ``chip_smoke.MODEL``'s decode bundle with that tree's
``io.export_decode_model`` (random weights from --seed), loads it with
that tree's ``DecodeModel`` on the card and runs --calls (default 50)
``DecodeModel.prefill`` calls at the --bound (default 128) bucket under
cProfile. It prints one JSON line: the host clock's median ms of a call
without the profiler, and the profiled time of a call split by where it
is spent:

    loop        core/lowering.py: the step function, run_op's dict
                building and rebinding
    ops         ops/*.py: the ops' compute functions and the torch calls
                they make
    kernels     kernels/*.py: the kernel wrappers and their calls
    module      models/*.py: a module's forward (the module path)
    serving     serving/ and io.py: bucket choice, padding, the fetches
    wait        the host waiting for the device (synchronize, the copy of
                the logits to the host)
    other       the rest (the profiler's own entry, import machinery)

A torch function (a builtin or torch's own Python) is charged to its
direct callers, each by the time it spent under that caller; a caller
that is itself torch's is charged to the area of the caller that spent
the most time in it. Beside the split: per op type, the calls and the
cumulative ms of its compute function a prefill (ops that share one
compute function are one entry, named by it), the top-level aten calls
and CUDA kernels a prefill (torch.profiler), and ``dead_views``, the
reshape calls that the layer norms make for Mean / Variance outputs
(ops/nn_ops.py) and their ms a prefill. cProfile charges every Python
call: its times are larger than the host clock's, and only their split
is read. --cpu runs a 6-layer, d_model-32 model on the CPU to rehearse
the script (no device metric).
"""

import argparse
import cProfile
import importlib.util
import json
import pstats
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

AREAS = (("/core/lowering.py", "loop"), ("/ops/", "ops"),
         ("/kernels/", "kernels"), ("/models/", "module"),
         ("/serving/", "serving"), ("/io.py", "serving"))


def own_area(func) -> str:
    """The area of a function of the port, or '' for anything else."""
    path, _, name = func
    if path == "~":
        if "synchroniz" in name or name == "<method 'cpu' of " \
                "'torch._C.TensorBase' objects>":
            return "wait"
        return ""
    if "paddle_tpu_torch" not in path:
        return ""
    for key, area in AREAS:
        if key in path:
            return area
    return "other"


def split_areas(stats: dict, n: int) -> dict:
    """{area: profiled ms a call}, torch's functions charged to their
    callers (the module docstring)."""
    memo: dict = {}

    def area_of(func) -> str:
        a = own_area(func)
        if a:
            return a
        if func in memo:
            return memo[func]
        memo[func] = "other"    # a cycle resolves to other
        callers = stats[func][4]
        if callers:
            top = max(callers.items(), key=lambda kv: kv[1][3])[0]
            memo[func] = area_of(top)
        return memo[func]

    out: dict = defaultdict(float)
    for func, (_, _, tt, _, callers) in stats.items():
        a = own_area(func)
        if a or not callers:
            out[a or "other"] += tt
            continue
        for caller, (_, _, ctt, _) in callers.items():
            out[area_of(caller)] += ctt
    return {k: round(1e3 * v / n, 4) for k, v in sorted(out.items())}


def per_op(stats: dict, registry, n: int) -> dict:
    """{op type: [calls a prefill, cumulative ms a prefill]} of the
    registered compute functions that ran."""
    types = defaultdict(list)
    for t in registry.registered_ops():
        code = registry.get_op(t).compute.__code__
        types[(code.co_filename, code.co_firstlineno, code.co_name)].append(t)
    out = {}
    for key, ts in types.items():
        if key in stats:
            _, nc, _, ct, _ = stats[key]
            out[ts[0] if len(ts) == 1 else key[2]] = [
                nc // n, round(1e3 * ct / n, 4)]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def dead_views(stats: dict, n: int) -> list:
    """[calls a prefill, ms a prefill] of the reshape calls made by the
    layer_norm op's compute function."""
    calls, tt = 0, 0.0
    for func, (_, _, _, _, callers) in stats.items():
        if func[0] != "~" or "reshape" not in func[2]:
            continue
        for caller, (_, nc, ctt, _) in callers.items():
            if caller[0].endswith("nn_ops.py") and \
                    caller[2] == "_layer_norm_op":
                calls += nc
                tt += ctt
    return [calls // n, round(1e3 * tt / n, 4)]


def torch_calls(torch, fn, n: int = 5) -> list:
    """[top-level aten calls, CUDA kernels] a call of fn, from
    torch.profiler over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
    aten = kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += 1
        elif e.name.startswith("aten::") and (
                e.cpu_parent is None
                or not e.cpu_parent.name.startswith("aten::")):
            aten += 1
    return [aten / n, kernels / n]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--bound", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.models.transformer import param_shapes
    from paddle_tpu_torch.serving.decode import DecodeModel

    if args.cpu:
        cs.MODEL = dict(vocab_size=64, n_layers=6, d_model=32, n_heads=2,
                        d_ff=64, max_context=2 * args.bound)
        geometry = dict(length_buckets=(args.bound // 2, args.bound),
                        slots=2, block_size=4, pool_blocks=64)
        device, card = "cpu", "cpu (rehearsal, not a device metric)"
    else:
        from paddle_tpu_torch.kernels import build
        torch.backends.cuda.matmul.allow_tf32 = False
        build.build(["flash_attention.cu", "paged_attention.cu"])
        geometry = dict(length_buckets=cs.BUCKETS, slots=cs.SLOTS,
                        block_size=cs.BLOCK, pool_blocks=cs.POOL_BLOCKS)
        device, card = None, cs.card_line()
    params = cs.make_params(np, param_shapes, args.seed)
    with tempfile.TemporaryDirectory() as d:
        io.export_decode_model(d, cs.MODEL, params=params, **geometry)
        del params
        model = DecodeModel(d, device=device)
    rng = np.random.default_rng(args.seed + 2)
    toks = rng.integers(1, cs.MODEL["vocab_size"], args.bound).tolist()
    for _ in range(3):
        model.prefill(toks)
    ms = []
    for _ in range(args.calls):
        t0 = time.perf_counter()
        model.prefill(toks)
        ms.append(1e3 * (time.perf_counter() - t0))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.calls):
        model.prefill(toks)
    prof.disable()
    stats = pstats.Stats(prof).stats
    areas = split_areas(stats, args.calls)
    print(json.dumps({
        "tree": str(args.tree), "card": card, "bound": args.bound,
        "calls": args.calls, "ms_median": round(statistics.median(ms), 4),
        "ms_min_max": [round(min(ms), 4), round(max(ms), 4)],
        "profiled_ms": round(sum(areas.values()), 4), "areas_ms": areas,
        "dead_views": dead_views(stats, args.calls),
        "aten_calls_kernels": torch_calls(torch,
                                          lambda: model.prefill(toks)),
        "per_op": per_op(stats, registry, args.calls)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
