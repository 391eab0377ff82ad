"""How far bfloat16 ResNet training runs sit apart on the CPU: the
readings behind the limits of ``tests/test_torch_resnet_bf16.py`` and of
``chip_smoke.py``'s phase 20.

Default: the narrow ResNet of ``tests/test_torch_resnet_bf16.py`` in its
eight cases (a bf16 program and AMP, both ``fused_xent`` settings, both
epilogue settings), 3 Momentum steps from the JAX package's startup
state. For each case it prints the test's readings (step-0 loss, loss,
gradients together and median, updates together and median, running
stats) three times: the port's bf16 run against the JAX package's; a
port run that sees half of each batch against the JAX package's (a
planted fault); and the JAX package's bf16 run against its float32 run
(its own spread, which sets the test's limits).

``--resnet50``: ResNet-50's stem and stages at full width, 64 px, 102
classes, batch 4 (``chip_smoke.build_resnet_cut``), at its full depth
(3, 4, 6, 3 blocks) and cut to one block a stage, two Momentum steps on
the CPU from one startup state: the float32 program's run, a bf16 run
whose images move by one bf16 step at one pixel in 64, and a bf16 run
on half of each batch, each against the bf16 run (the relative rms of
the first-step gradients and of the updates, all parameters together
and the median over them).

``--chain-forward``: phase 21's readings on the CPU. The bench's bf16
ResNet-50 (``chip_smoke.build_resnet50_bf16``, full depth and width) at
64 px, batch 8, its training-mode forward pruned to loss and accuracy
from one startup state, the float32 program (``build_resnet50``) from the
same state (``chip_smoke.bf16_forward_runs``); the chain's gate patched
open on the CPU and CHAIN_MIN_S lowered to 16, so that the port's plain
chain takes the 10 rest blocks at 16², 8² and 4² as the card's takes
them at 56², 28² and 14². Each run against the float32 forward (loss,
relative; the per-image losses' relative rms; the 120 stat outputs'
largest and median relative rms): the
bf16 composition (the reading), the bf16 chain, and two that must sit
apart: the bf16 composition with one bf16 step at one pixel in 64 (how
chaotic the forward is), and the chain on a batch whose second half
repeats its first (a planted fault).

``--chain-step``: phase 22's readings on the CPU. First ResNet-50's stem
and stages at full width cut to (2, 2, 2, 1) blocks, 224 px, 1000
classes, batch 8, one Momentum step from one startup state, the bf16
program's updates against the float32 program's (the largest and median
relative rms over the vars, parameters and velocities apart from the
running stats): how far bf16 alone moves a deeper program's step. Then
``chip_smoke.bf16_chain_step_held`` itself at batch 8 with the stages
cut to 8², 6² and 4², the chain's gate open on the CPU at CHAIN_MIN_S
16, the executor on the CPU and each wrapper counting its calls: the
readings of each stage program, the chain's and those of the chain
without tap gradients, which must fail.

    env JAX_PLATFORMS=cpu python scripts/resnet_bf16_spread_cpu.py
    python scripts/resnet_bf16_spread_cpu.py --resnet50
    python scripts/resnet_bf16_spread_cpu.py --chain-forward
    python scripts/resnet_bf16_spread_cpu.py --chain-step
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def narrow():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import test_torch_resnet_bf16 as t

    main, startup, _, _ = t._build(t.jpt, t.jprog, t.jres, True, "float32")
    scope = t.JScope()
    t.jpt.Executor().run(startup, scope=scope)
    start = {n: np.array(scope.find_var(n)) for n in t._persistables(main)}
    for kind, fx, ep in t.CASES:
        t.jfc.INTERPRET = ep == "kernels"
        os.environ["PT_FUSE_EPILOGUE"] = ("always" if ep == "kernels"
                                          else "never")
        jmain, _, javg, jpred = t._build(t.jpt, t.jprog, t.jres, fx, kind)
        tmain, _, tavg, tpred = t._build(t.pt, t.tprog, t.tres, fx, kind)
        fmain, _, favg, fpred = t._build(t.jpt, t.jprog, t.jres, fx,
                                         "float32")
        params = [p.name for p in jmain.global_block.all_parameters()]
        jax_run = t._jax_run(jmain, javg, jpred, start, kind, params)
        f32_run = t._jax_run(fmain, favg, fpred, start, "float32", params)
        port = t._port_run(tmain, tavg, tpred, start, kind, params)
        half = t._port_run(tmain, tavg, tpred, start, kind, params,
                           feeds=t._half_batch)
        own = dict(jax_run, end={n: t.torch.from_numpy(v)
                                 for n, v in jax_run["end"].items()})
        for what, got, want in (("port", port, jax_run),
                                ("half batch", half, jax_run),
                                ("JAX bf16 - float32", own, f32_run)):
            r = t._readings(got, want, params, start)
            print(f"{kind} {'fused_xent' if fx else 'softmax_head'} {ep}, "
                  f"{what}: " + ", ".join(f"{k} {v:.4g}"
                                          for k, (v, _) in r.items()),
                  flush=True)


def resnet50():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as pt

    r = cs.RESNET_REDUCED
    exe = pt.Executor(pt.CPUPlace())

    def rel(a, b):
        return cs.rms(np, a - b) / cs.rms(np, b)

    for blocks in ((3, 4, 6, 3), cs.RESNET_BF16_BLOCKS):
        progs = {d: cs.build_resnet_cut(pt, 0, d, blocks)
                 for d in ("bfloat16", "float32")}
        params = [p.name for p in
                  progs["bfloat16"][0].global_block.all_parameters()]
        scope0 = pt.Scope()
        exe.run(progs["bfloat16"][1], scope=scope0)
        start = {p: scope0.get_numpy(p) for p in params}

        def run(dtype, change=None):
            prog, _, avg = progs[dtype]
            scope = pt.Scope()
            for n in scope0.local_var_names():
                scope.set_var(n, scope0.find_var(n).clone())
            for i in range(2):
                feed = cs.resnet_varied(np, i, r["batch"], r["image"],
                                        center=0.5)
                if change == "one pixel in 64":
                    bits = torch.from_numpy(feed["data"]).bfloat16() \
                        .view(torch.int16).clone().reshape(-1)
                    bits[::64] += 1
                    feed["data"] = bits.view(torch.bfloat16).reshape(
                        feed["data"].shape)
                elif change == "half batch":
                    feed = {k: v[:r["batch"] // 2] for k, v in feed.items()}
                out = exe.run(prog, feed=feed, fetch_list=[avg] + (
                    [p + "@GRAD" for p in params] if i == 0 else []),
                    scope=scope)
                if i == 0:
                    grads = dict(zip(params, out[1:]))
            return grads, {p: scope.get_numpy(p) - start[p] for p in params}

        ref = run("bfloat16")
        for what, got in (("float32", run("float32")),
                          ("one pixel in 64", run("bfloat16",
                                                  "one pixel in 64")),
                          ("half batch", run("bfloat16", "half batch"))):
            line = []
            for name, g, w in (("gradients", got[0], ref[0]),
                               ("updates", got[1], ref[1])):
                cat = [np.concatenate([d[p].ravel() for p in params])
                       for d in (g, w)]
                med = np.median([rel(g[p], w[p]) for p in params])
                line.append(f"{name} {rel(*cat):.4g} median {med:.4g}")
            print(f"ResNet-50 blocks {blocks}, {what} vs bf16: "
                  + ", ".join(line), flush=True)


def chain_forward():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import fused_ops

    exe = pt.Executor(pt.CPUPlace())
    built, bf = cs.build_resnet50(pt, 0), cs.build_resnet50_bf16(pt, 0)
    feed = cs.resnet_varied(np, 0, 8, 64)
    bits = torch.from_numpy(feed["data"]).bfloat16().view(torch.int16) \
        .clone().reshape(-1)
    bits[::64] += 1
    stepped = bits.view(torch.bfloat16).float().numpy().reshape(
        feed["data"].shape)
    halved = np.concatenate([feed["data"][:4]] * 2)
    run = cs.bf16_forward_runs(np, pt, exe, bf, built, feed)
    # the names are taken: now open the gate on the CPU at 64 px
    fused_ops.fused_block_enabled = lambda device: \
        fused_ops.chain_requested()
    fused_ops.CHAIN_MIN_S = 16
    chained = []
    chain_block = fused_ops._chain_block

    def counted(x, *args):
        chained.append(tuple(x.shape))
        return chain_block(x, *args)

    fused_ops._chain_block = counted
    f32 = run("float32")
    comp = run("bf16")
    for what, got in (("bf16 composition", comp),
                      ("bf16 chain", run("chain")),
                      ("bf16 composition, one pixel in 64 a bf16 step",
                       run("bf16", data=stepped)),
                      ("bf16 chain, half the batch repeated",
                       run("chain", data=halved))):
        loss, terms, top, med = cs.forward_distance(np, got, f32)
        print(f"{what} vs float32: loss {got[0]!r} ({loss:.4g}), per-image "
              f"losses {terms:.4g}, stat outputs largest {top:.4g}, median "
              f"{med:.4g} ({len(got[2])} outputs); blocks through the chain "
              f"so far {len(chained)}", flush=True)
    loss, terms, top, med = cs.forward_distance(
        np, run("bf16", data=stepped), comp)
    print(f"one pixel in 64 a bf16 step vs the bf16 composition: loss "
          f"{loss:.4g}, per-image losses {terms:.4g}, stat outputs largest "
          f"{top:.4g}, median {med:.4g}")


def chain_step():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import executor, types
    from paddle_tpu_torch.kernels import fused_block as fb
    from paddle_tpu_torch.ops import fused_ops

    exe = pt.Executor(pt.CPUPlace())
    blocks, r = (2, 2, 2, 1), dict(image=224, class_dim=1000, batch=8)
    cs.RESNET_REDUCED = r
    progs = {d: cs.build_resnet_cut(pt, 0, d, blocks)
             for d in ("bfloat16", "float32")}
    scope0 = pt.Scope()
    exe.run(progs["bfloat16"][1], scope=scope0)
    start = {n: scope0.get_numpy(n) for n in scope0.local_var_names()}
    feed = cs.resnet_varied(np, 0, r["batch"], r["image"], center=0.5)
    ups = {}
    for dtype, (prog, _, avg) in progs.items():
        scope = pt.Scope()
        for n, v in start.items():
            scope.set_var(n, torch.from_numpy(v.copy()))
        exe.run(prog, feed=feed, fetch_list=[avg], scope=scope)
        ups[dtype] = {n: scope.get_numpy(n) - v for n, v in start.items()}
    for which in ("params", "stats"):
        top, med = cs.bf16_update_distance(np, ups["bfloat16"],
                                           ups["float32"], which)
        print(f"ResNet-50 cut to {blocks} blocks, {r['image']} px, batch "
              f"{r['batch']}, bf16 vs float32 updates ({which}): largest "
              f"{top:.4g}, median {med:.4g}", flush=True)

    def cpu(device=None):
        return torch.device("cpu")

    types.resolve_device = executor.resolve_device = cpu
    fused_ops.fused_block_enabled = lambda device: \
        fused_ops.chain_requested()
    fused_ops.CHAIN_MIN_S = 16
    cs.RESNET = dict(cs.RESNET, batch=8)
    cs.CHAIN_SHAPES = ((256, 64, 8), (512, 128, 6), (1024, 256, 4))

    def counted(name):
        wrapper = getattr(fb, name)

        def call(*args):
            call.launches += 1
            return wrapper(*args)
        call.launches = 0
        setattr(fb, name, call)

    for name in (cs.CHAIN_BF16_KERNELS + cs.CHAIN_BF16_BWD_KERNELS
                 + cs.CHAIN_KERNELS + cs.CHAIN_BWD_KERNELS):
        counted(name)
    cs.bf16_chain_step_held(np, torch, fb, "CPU", 0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resnet50", action="store_true")
    ap.add_argument("--chain-forward", action="store_true")
    ap.add_argument("--chain-step", action="store_true")
    args = ap.parse_args()
    if args.chain_step:
        chain_step()
    elif args.chain_forward:
        chain_forward()
    elif args.resnet50:
        resnet50()
    else:
        narrow()
