"""Training step time of the full-width stacked LSTM on one GPU, float32
against bf16 AMP in turns: chip_smoke.py phases 9 and 17's program.

    python scripts/torch_lstm_amp_step_probe.py [--rounds 12] [--steps 5]

Builds ``chip_smoke.LSTM``'s training program once (Adam at lr 1e-3,
random weights from --seed), runs startup and one warm-up step of each
mode, then --rounds rounds of --steps float32 steps and --steps AMP steps
(``amp_dtype`` "bfloat16" set and cleared on the one program and scope),
the mode that goes first alternating from round to round, on bench.py
bench_lstm's varied feeds. Each step is timed by the host clock around
``Executor.run`` (the loss fetch syncs). Prints, for each mode, the
median and the quartiles of ms a step over all rounds, the rounds whose
median the AMP steps beat, and, from one profiled step of each mode, the
CUDA kernels and the aten ops (the host's calls into PyTorch) a step with
the ten commonest ops; then one JSON line with the card.
"""

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [round(q[0], 3), round(statistics.median(xs), 3), round(q[2], 3)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.card_line()
    build.build(["fused_lstm.cu", "fused_lstm_bf16.cu"])
    b, t = cs.LSTM["batch"], cs.LSTM["seq_len"]
    main_prog, startup, loss, _ = cs.build_lstm(pt, cs.LSTM, args.seed)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feeds = [cs.lstm_varied(np, i, b, t, cs.LSTM["dict_size"])
             for i in range(args.steps)]
    modes = {"float32": None, "AMP": "bfloat16"}

    def run(mode, feed):
        main_prog.amp_dtype = modes[mode]
        t0 = time.perf_counter()
        exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        return 1e3 * (time.perf_counter() - t0)

    for mode in modes:
        run(mode, feeds[0])
    ms = {m: [] for m in modes}
    amp_wins = 0
    for r in range(args.rounds):
        order = list(modes) if r % 2 == 0 else list(modes)[::-1]
        this = {}
        for mode in order:
            this[mode] = [run(mode, f) for f in feeds]
            ms[mode] += this[mode]
        amp_wins += (statistics.median(this["AMP"])
                     < statistics.median(this["float32"]))
    for mode in modes:
        print(f"{mode}: ms a step (quartiles, median) {quartiles(ms[mode])} "
              f"over {len(ms[mode])} steps [{card}]")
    print(f"AMP's median below float32's in {amp_wins} of {args.rounds} "
          f"rounds [{card}]")
    counts = {}
    for mode in modes:
        run(mode, feeds[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(mode, feeds[0])
            torch.cuda.synchronize()
        ops = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("aten::"))
        kernels = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        counts[mode] = dict(kernels=kernels, aten_ops=sum(ops.values()))
        print(f"{mode} step: {kernels} CUDA kernels, {sum(ops.values())} "
              f"aten ops, commonest {ops.most_common(10)} [{card}]")
    main_prog.amp_dtype = None
    print(json.dumps({"card": card, "ms_quartiles": {
        m: quartiles(v) for m, v in ms.items()}, "amp_wins": amp_wins,
        "rounds": args.rounds, "counts": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
