"""Prefill time of the decode bundle at full width, on one GPU, for one tree.

    python scripts/torch_prefill_probe.py [--tree DIR] [--reps N] [--seed N]

Imports ``paddle_tpu_torch`` from DIR (default: this repository; e.g. the
parent commit unpacked by ``git archive`` into a git-ignored directory),
exports ``chip_smoke.MODEL``'s decode bundle (random weights from
--seed, the buckets ``chip_smoke.BUCKETS``) with that tree's
``io.export_decode_model``, loads it with that tree's ``DecodeModel`` on
the card, and prints one JSON line: per bucket the host-clock ms of one
``DecodeModel.prefill``, the median and the min-max of --reps (default
20) calls after one warm-up, each timed alone (a call ends in a copy of
the last position's logits to the host, as ``chip_smoke.py`` phase 4
times it), and, from one call under
torch.profiler, its device busy ms and idle share. Two trees are
compared in one chip call, in turns:

    for t in P . . P; do python scripts/torch_prefill_probe.py --tree $t; done
"""

import argparse
import importlib.util
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import numpy as np
    import torch

    # this tree's chip_smoke.py (MODEL, BUCKETS, the profiler helper),
    # whichever tree's paddle_tpu_torch is measured
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import io
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.transformer import param_shapes
    from paddle_tpu_torch.serving.decode import DecodeModel

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    build.build(["flash_attention.cu", "paged_attention.cu"])
    params = cs.make_params(np, param_shapes, args.seed)
    with tempfile.TemporaryDirectory() as d:
        io.export_decode_model(d, cs.MODEL, params=params,
                               length_buckets=cs.BUCKETS, slots=cs.SLOTS,
                               block_size=cs.BLOCK,
                               pool_blocks=cs.POOL_BLOCKS)
        del params
        model = DecodeModel(d)
    rng = np.random.default_rng(args.seed + 2)
    out = {"tree": str(args.tree), "card": card, "buckets": {}}
    for bound in cs.BUCKETS:
        toks = rng.integers(1, cs.MODEL["vocab_size"], bound).tolist()
        model.prefill(toks)
        ms = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            model.prefill(toks)
            ms.append(1e3 * (time.perf_counter() - t0))
        wall, by_name, _ = cs.profiled(torch, lambda: model.prefill(toks), 1)
        busy = sum(by_name.values())
        out["buckets"][bound] = {
            "ms_median": round(statistics.median(ms), 3),
            "ms_min_max": [round(min(ms), 3), round(max(ms), 3)],
            "profiled_wall_ms": round(wall, 3),
            "device_busy_ms": round(busy, 3),
            "idle_share": round(1 - busy / wall, 3) if by_name else None}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
