"""Training step time of the full-width Transformer LM, on one GPU, for one
tree: chip_smoke.py phase 5's program, in float32 or under AMP.

    python scripts/torch_lm_step_probe.py [--tree DIR] [--amp] [--steps N]

Imports ``paddle_tpu_torch`` from DIR (default: this repository; e.g. the
parent commit unpacked by ``git archive`` into a git-ignored directory),
builds ``chip_smoke.MODEL``'s training program at ``chip_smoke.TRAIN``'s
shape with that tree's builders (Adam at lr 1e-4, random weights from
--seed), runs startup, one warm-up step and --steps (default 6) timed
steps on phase 5's feeds (``lm_probe_feeds``), each timed by the host
clock around ``Executor.run`` (the loss fetch syncs), and prints one JSON
line: the mean, median and min-max ms a step, and the card. --amp sets
``amp_dtype = "bfloat16"`` (a tree without the AMP port refuses it). Two
trees are compared in one chip call, in turns:

    for t in P . . P; do python scripts/torch_lm_step_probe.py --tree $t; done
"""

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--amp", action="store_true")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import numpy as np
    import torch

    # this tree's chip_smoke.py (MODEL, TRAIN, the feeds and builder),
    # whichever tree's paddle_tpu_torch is measured
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.card_line()
    build.build([s for s in build.SOURCES if "attention" in s])
    b, s = cs.TRAIN["batch"], cs.TRAIN["seq_len"]
    main_prog, startup, avg = cs.build_lm(pt, cs.MODEL, s, args.seed)
    if args.amp:
        main_prog.amp_dtype = "bfloat16"
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    ms, losses = [], []
    for i in range(1 + args.steps):
        feed = cs.lm_probe_feeds(np, i, b, s, cs.MODEL["vocab_size"])
        t0 = time.perf_counter()
        loss, = exe.run(main_prog, feed=feed, fetch_list=[avg], scope=scope)
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss[0]))
    timed = ms[1:]
    print(json.dumps({
        "tree": str(args.tree), "amp": args.amp, "card": card,
        "ms_mean": round(statistics.mean(timed), 3),
        "ms_median": round(statistics.median(timed), 3),
        "ms_min_max": [round(min(timed), 3), round(max(timed), 3)],
        "warmup_ms": round(ms[0], 3), "losses": losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
