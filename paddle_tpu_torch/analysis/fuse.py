"""Conv-epilogue fusion pass: conv2d → batch_norm → relu/add chains
rewritten into single ``fused_conv2d`` ops (ops/fused_ops.py).

Counterpart of ``paddle_tpu/analysis/fuse.py``, rule for rule, so that
the two packages give the same fused program for the same build calls.
The unfused chain writes the conv output, reads it again for the BN
statistics, again for normalize (+ add) (+ ReLU), and writes the
activation; the fused op's epilogue is two passes over the conv output
(kernels/fused_conv.py: the channel-stats kernel and the apply kernel).

Contract:

* REWRITE, never resynthesis: the pass runs on a CLONE inside the
  Executor's pre-pass (core/executor.py), the caller's Program object is
  never touched, and ``PT_FUSE=0`` returns the original object.
* An intermediate is fused away only when it cannot be observed: exactly
  one producer and one consumer (the absorbed successor), not a fetch
  target, autodiff anchor, parameter, data or persistable var, and not
  referenced by any sub-block.
* Moving the absorbed ops' reads and writes to the insertion point must
  not cross a conflicting access; chains that fail shrink or are
  skipped.
* State threading is kept verbatim: the BN's MeanOut/VarianceOut/
  SavedMean/SavedVariance names ride onto the fused op unchanged.
* Training programs fuse too: the backward is the single ``autodiff``
  pseudo-op, which differentiates whatever block prefix it sees.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set, Tuple

from ..core.lowering import AUTODIFF_OP
from ..core.program import OpDesc, Program, sub_block_var_names

#: BN attrs carried onto the fused op (conv attrs are copied wholesale)
_BN_ATTRS = ("epsilon", "momentum", "is_test", "use_global_stats")

#: fused programs memoized per (source fingerprint, protected names) —
#: the executor calls maybe_fuse on every run; re-cloning per step would
#: dwarf the fusion win
_MEMO: Dict[Tuple[str, Tuple[str, ...]], Program] = {}
_MEMO_CAP = 64


def fuse_enabled() -> bool:
    return os.environ.get("PT_FUSE", "1") not in ("0", "never")


def _autodiff_protected(program) -> Set[str]:
    """Names the autodiff pseudo-op anchors by ATTR, invisible to the
    def-use maps: the loss var, the params, and the grad outputs."""
    names: Set[str] = set()
    for block in program.blocks:
        for op in block.ops:
            if op.type != AUTODIFF_OP:
                continue
            a = op.attrs or {}
            if a.get("loss"):
                names.add(a["loss"])
            names.update(a.get("params", ()))
            names.update(a.get("grad_names", ()))
            names.update(op.output_names())
    return names


def _fuse_block0(program: Program, protect: Set[str]) -> int:
    """Rewrite eligible chains in block 0 in place; returns #chains."""
    block = program.global_block
    ops = block.ops

    readers: Dict[str, List[int]] = {}
    writers: Dict[str, List[int]] = {}
    for i, op in enumerate(ops):
        # a sub-block touching a name makes this op both a reader and a
        # writer of it — either direction disqualifies elimination
        sub = sub_block_var_names(program, op)
        for nm in set(op.input_names()) | sub:
            readers.setdefault(nm, []).append(i)
        for nm in set(op.output_names()) | sub:
            writers.setdefault(nm, []).append(i)

    def eliminable(name: str, consumer: int) -> bool:
        if name in protect:
            return False
        v = block.vars.get(name)
        if v is None or v.persistable or v.is_parameter \
                or getattr(v, "is_data", False):
            return False
        return writers.get(name, []) != [] \
            and len(writers[name]) == 1 \
            and readers.get(name, []) == [consumer]

    used: Set[int] = set()
    replacement: Dict[int, OpDesc] = {}
    dead_vars: Set[str] = set()
    n_chains = 0

    for i, conv in enumerate(ops):
        if conv.type != "conv2d" or i in used:
            continue
        outs = conv.output("Output")
        if len(outs) != 1:
            continue
        cv = outs[0]
        cons = readers.get(cv, [])
        if len(cons) != 1 or cons[0] in used:
            continue
        j = cons[0]
        bn = ops[j]
        if bn.type != "batch_norm" or bn.input("X") != [cv] \
                or not eliminable(cv, j):
            continue
        # dtype agreement through the epilogue: the chain's tensors must
        # share the conv output's dtype (f32 BN params are slot inputs,
        # not chain tensors)
        by = bn.output("Y")[0]
        cv_v, by_v = block.vars.get(cv), block.vars.get(by)
        if cv_v is None or by_v is None \
                or str(cv_v.dtype) != str(by_v.dtype):
            continue

        absorbed = [i, j]
        act = "relu" if (bn.attrs or {}).get("fuse_with_relu") else ""
        addend: Optional[str] = None
        addend_read_at = None
        out_name = by

        def _next_sole_consumer(name, cur):
            c = readers.get(name, [])
            if len(c) == 1 and c[0] not in used and eliminable(name, c[0]):
                return c[0]
            return None

        if not act:
            k = _next_sole_consumer(by, j)
            nxt = ops[k] if k is not None else None
            if nxt is not None and nxt.type == "relu" \
                    and nxt.input("X") == [by]:
                act, out_name = "relu", nxt.output("Out")[0]
                absorbed.append(k)
            elif nxt is not None and nxt.type == "elementwise_add":
                xs, ys = nxt.input("X"), nxt.input("Y")
                other = None
                if xs == [by] and ys != [by] and len(ys) == 1:
                    other = ys[0]
                elif ys == [by] and xs != [by] and len(xs) == 1:
                    other = xs[0]
                ov = block.vars.get(other) if other else None
                # no-broadcast adds only: the fused epilogue adds a
                # same-shape residual, nothing else
                if ov is not None and by_v is not None \
                        and tuple(ov.shape) == tuple(by_v.shape) \
                        and str(ov.dtype) == str(by_v.dtype):
                    ao = nxt.output("Out")[0]
                    addend, addend_read_at = other, k
                    out_name = ao
                    absorbed.append(k)
                    r = _next_sole_consumer(ao, k)
                    if r is not None and ops[r].type == "relu" \
                            and ops[r].input("X") == [ao]:
                        act, out_name = "relu", ops[r].output("Out")[0]
                        absorbed.append(r)

        last = max(absorbed)
        aset = set(absorbed)

        # --- move-safety: reads the fused op performs at `last` must see
        # the same values the absorbed ops saw at their own positions,
        # and writes moved to `last` must not skip past a reader.
        read_from = {}
        for nm in conv.input_names():
            read_from[nm] = min(read_from.get(nm, i), i)
        for nm in bn.input_names():
            if nm != cv:
                read_from[nm] = min(read_from.get(nm, j), j)
        if addend is not None:
            read_from[addend] = min(read_from.get(addend, addend_read_at),
                                    addend_read_at)
        stat_outs = [n for s in ("MeanOut", "VarianceOut", "SavedMean",
                                 "SavedVariance") for n in bn.output(s)]
        hazard = False
        for nm, pos in read_from.items():
            if any(pos < w < last and w not in aset
                   for w in writers.get(nm, [])):
                hazard = True
        for nm in stat_outs:
            if any(j < r <= last and r not in aset
                   for r in readers.get(nm, [])):
                hazard = True
            if any(j < w <= last and w not in aset
                   for w in writers.get(nm, [])):
                hazard = True
        if hazard:
            continue

        inputs = {"Input": list(conv.input("Input")),
                  "Filter": list(conv.input("Filter")),
                  "Scale": list(bn.input("Scale")),
                  "Bias": list(bn.input("Bias")),
                  "Mean": list(bn.input("Mean")),
                  "Variance": list(bn.input("Variance"))}
        if addend is not None:
            inputs["Addend"] = [addend]
        outputs = {"Output": [out_name],
                   "MeanOut": list(bn.output("MeanOut")),
                   "VarianceOut": list(bn.output("VarianceOut")),
                   "SavedMean": list(bn.output("SavedMean")),
                   "SavedVariance": list(bn.output("SavedVariance"))}
        attrs = dict(conv.attrs or {})
        for key in _BN_ATTRS:
            if key in (bn.attrs or {}):
                attrs[key] = bn.attrs[key]
        attrs["act"] = act
        attrs["with_add"] = addend is not None
        attrs["fused_from"] = [ops[idx].type for idx in sorted(absorbed)]

        replacement[last] = OpDesc("fused_conv2d", inputs, outputs, attrs)
        used.update(aset)
        dead_vars.add(cv)
        if out_name != by:
            dead_vars.add(by)
        if addend is not None and act and out_name != by:
            ao_mid = ops[absorbed[2]].output("Out")[0]
            if ao_mid != out_name:
                dead_vars.add(ao_mid)
        n_chains += 1

    if not n_chains:
        return 0
    block.ops = [replacement.get(idx, op) for idx, op in enumerate(ops)
                 if idx in replacement or idx not in used]
    for nm in dead_vars:
        block.vars.pop(nm, None)
    program.invalidate_cache()
    return n_chains


def fuse_program(program: Program, protect=()) -> Tuple[Program, int]:
    """Clone + rewrite: returns (fused clone, #chains). The input
    program is never mutated. `protect` names (fetch targets) are never
    fused away; autodiff anchors are protected automatically."""
    fused = program.clone()
    prot = set(protect) | _autodiff_protected(fused)
    n = _fuse_block0(fused, prot)
    return fused, n


def maybe_fuse(program: Program, protect=()) -> Program:
    """The executor's pre-pass entry: the fused clone when the pass is
    on and found chains, the ORIGINAL OBJECT otherwise (so PT_FUSE=0 —
    and programs with nothing to fuse — stay bit-for-bit identical,
    fingerprint included). Memoized per (fingerprint, protect)."""
    if not fuse_enabled():
        return program
    blk = program.global_block
    if not any(op.type == "conv2d" for op in blk.ops):
        return program
    key = (program.fingerprint(), tuple(sorted(set(protect))))
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    fused, n = fuse_program(program, protect)
    result = fused if n else program
    if len(_MEMO) >= _MEMO_CAP:
        _MEMO.pop(next(iter(_MEMO)))
    _MEMO[key] = result
    return result
