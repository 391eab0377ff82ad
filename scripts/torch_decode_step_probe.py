"""Decode-step time of the decode bundle at full width, on one GPU, for one
tree.

    python scripts/torch_decode_step_probe.py [--tree DIR] [--reps N]
        [--seed N]

Imports ``paddle_tpu_torch`` from DIR (default: this repository; e.g. the
parent commit unpacked by ``git archive`` into a git-ignored directory),
exports ``chip_smoke.MODEL``'s decode bundle (random weights from --seed)
with that tree's ``io.export_decode_model``, loads it with that tree's
``DecodeModel`` on the card, seeds every slot with the prefill of a
random prompt (64 to 900 tokens), and prints one JSON line: the
host-clock ms of one ``DecodeModel.decode_step`` over all slots (it ends
in the logits' copy to the host, as the scheduler calls it), the median,
quartiles and min-max of --reps (default 40) steps after three warm-up
steps, and, from three steps under torch.profiler, the device busy ms a
step and the idle share. Whatever the tree runs the step with (the
parent's module or this tree's step program), the call is the same. Two
trees are compared in one chip call, in turns:

    for t in P . . P; do
        python scripts/torch_decode_step_probe.py --tree $t; done
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
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import numpy as np
    import torch

    # this tree's chip_smoke.py (MODEL, the geometry, the profiler
    # helper), whichever tree's paddle_tpu_torch is measured
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import io
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.transformer import param_shapes
    from paddle_tpu_torch.serving.decode import DecodeModel
    from paddle_tpu_torch.serving.decode.kv_cache import (block_table_row,
                                                          blocks_for_tokens)

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
    rng = np.random.default_rng(args.seed + 3)
    vocab, steps = cs.MODEL["vocab_size"], args.reps + 6
    lens = rng.integers(64, 901, model.slots).astype(np.int32)
    tables = np.zeros((model.slots, model.max_blocks_per_seq), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        blocks = list(range(nxt, nxt + blocks_for_tokens(int(n) + steps,
                                                         model.block_size)))
        nxt += len(blocks)
        _, kv = model.prefill(rng.integers(1, vocab, int(n)).tolist())
        model.seed_sequence(blocks, kv)
        tables[i] = block_table_row(blocks, model.max_blocks_per_seq)
    state = {"lens": lens.copy()}

    def step():
        state["lens"] += 1
        model.decode_step(rng.integers(1, vocab, model.slots),
                          state["lens"], tables)

    for _ in range(3):
        step()
    ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step()
        ms.append(1e3 * (time.perf_counter() - t0))
    wall, by_name, _ = cs.profiled(torch, step, 3)
    busy = sum(by_name.values())
    q = statistics.quantiles(ms, n=4)
    print(json.dumps({
        "tree": str(args.tree), "card": card,
        "slots": model.slots, "keys": int(lens.sum()),
        "ms_median": round(statistics.median(ms), 3),
        "ms_quartiles": [round(q[0], 3), round(q[2], 3)],
        "ms_min_max": [round(min(ms), 3), round(max(ms), 3)],
        "profiled_wall_ms": round(wall, 3),
        "device_busy_ms": round(busy, 3),
        "idle_share": round(1 - busy / wall, 3) if by_name else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
