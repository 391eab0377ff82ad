"""The Program IR.

Counterpart of ``paddle_tpu/core/program.py``: ``VarDesc``, ``OpDesc``,
``Block`` and ``Program``, the default-program machinery, unique names
and remat scopes. The IR is the JAX package's, field for field
(``to_dict`` gives the same dict), so the same build calls give the same
program in both packages: the same ops in order and the same var names
(the weight carry between them depends on it).

A Program is a description only. The port's Executor (core/executor.py)
runs it op by op through torch (core/lowering.py). ``clone`` (with
``for_test``), the dict/JSON round trip and the memoized ``fingerprint``
serve the conv-fusion pass (analysis/fuse.py), which rewrites a clone
and keys its memo by the fingerprint; ``clone(for_test=True)`` and
``prune`` make an inference program out of a training one.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence

from .types import VarKind, normalize_dtype

__all__ = ["unique_name", "reset_unique_names", "unique_name_guard",
           "remat_scope", "op_block_refs", "sub_block_var_names", "VarDesc",
           "OpDesc", "Block", "Program", "default_main_program",
           "default_startup_program", "switch_main_program",
           "switch_startup_program", "program_guard"]


# ---------------------------------------------------------------------------
# unique_name
# ---------------------------------------------------------------------------

class _UniqueNameGenerator:
    def __init__(self):
        self.ids: Dict[str, int] = {}
        self.prefix = ""

    def __call__(self, key: str) -> str:
        tmp = self.ids.get(key, 0)
        self.ids[key] = tmp + 1
        return f"{self.prefix}{key}_{tmp}"


_name_gen = _UniqueNameGenerator()


def unique_name(key: str) -> str:
    return _name_gen(key)


def reset_unique_names():
    _name_gen.ids.clear()


class unique_name_guard:
    """`with unique_name_guard():` builds with fresh name counters and
    restores the caller's afterwards: a program built inside gets the
    names it would get first thing in a process (io.export_decode_model
    writes reproducible program files so)."""

    def __enter__(self):
        self._saved = dict(_name_gen.ids)
        _name_gen.ids.clear()

    def __exit__(self, *exc):
        _name_gen.ids.clear()
        _name_gen.ids.update(self._saved)
        return False


# ---------------------------------------------------------------------------
# Remat scopes: ops appended inside `with remat_scope(tag):` carry
# attrs["remat_scope"] = tag, as in the JAX package. The port's lowering
# does not recompute activations yet and refuses such ops (not ported).
# ---------------------------------------------------------------------------

_remat_stack: List[tuple] = []


class remat_scope:
    """policy: None, "save_attn" or "dots", recorded on the ops as in the
    JAX package (``remat_policy``)."""

    def __init__(self, tag: str, policy: Optional[str] = None):
        self.tag = tag
        self.policy = policy

    def __enter__(self):
        _remat_stack.append((self.tag, self.policy))
        return self

    def __exit__(self, *exc):
        _remat_stack.pop()
        return False


def current_remat_scope() -> Optional[str]:
    return _remat_stack[-1][0] if _remat_stack else None


def current_remat_policy() -> Optional[str]:
    return _remat_stack[-1][1] if _remat_stack else None


def op_block_refs(op) -> List[int]:
    """Block indices an op references through its BLOCK-typed attrs
    (sub_block / true_block / false_block / sub_blocks)."""
    refs: List[int] = []
    for key in ("sub_block", "true_block", "false_block"):
        if key in op.attrs:
            refs.append(op.attrs[key])
    refs.extend(op.attrs.get("sub_blocks", ()))
    return refs


def sub_block_var_names(program: "Program", op) -> set:
    """Every var name any reachable sub-block of `op` reads or writes
    (sub-block ops read outer vars the control-flow op does not declare).
    Invalid block indices are skipped."""
    names: set = set()
    todo = [bi for bi in op_block_refs(op)
            if isinstance(bi, int) and 0 <= bi < len(program.blocks)]
    seen: set = set()
    while todo:
        bi = todo.pop()
        if bi in seen:
            continue
        seen.add(bi)
        for sop in program.blocks[bi].ops:
            names |= set(sop.input_names()) | set(sop.output_names())
            todo.extend(bj for bj in op_block_refs(sop)
                        if isinstance(bj, int) and 0 <= bj < len(program.blocks))
    return names


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

class VarDesc:
    """A named, typed, shaped variable slot in a Block. shape may hold -1
    for the batch dimension; the feed binds it at run time."""

    __slots__ = (
        "name", "shape", "dtype", "kind", "persistable", "is_parameter",
        "stop_gradient", "lod_level", "initializer", "trainable", "regularizer",
        "need_clip", "is_data", "optimize_attr", "gradient_clip_attr",
        "sharding", "seq_len_var", "wire_codec",
    )

    def __init__(self, name: str, shape: Sequence[int] = (), dtype: str = "float32",
                 kind: str = VarKind.DENSE, persistable: bool = False,
                 is_parameter: bool = False, stop_gradient: bool = False,
                 lod_level: int = 0):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = normalize_dtype(dtype)
        self.kind = kind
        self.persistable = persistable
        self.is_parameter = is_parameter
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.initializer = None
        self.trainable = True
        self.regularizer = None
        self.need_clip = True
        self.is_data = False
        self.sharding = None
        self.seq_len_var = None
        self.wire_codec = None

    def to_dict(self) -> dict:
        return {
            "name": self.name, "shape": list(self.shape), "dtype": self.dtype,
            "kind": self.kind, "persistable": self.persistable,
            "is_parameter": self.is_parameter, "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level, "trainable": self.trainable,
            "is_data": self.is_data,
            "sharding": list(self.sharding) if self.sharding is not None else None,
            "seq_len_var": self.seq_len_var,
            "wire_codec": self.wire_codec,
        }

    @staticmethod
    def from_dict(d: dict) -> "VarDesc":
        v = VarDesc(d["name"], d["shape"], d["dtype"], d.get("kind", VarKind.DENSE),
                    d.get("persistable", False), d.get("is_parameter", False),
                    d.get("stop_gradient", False), d.get("lod_level", 0))
        v.trainable = d.get("trainable", True)
        v.is_data = d.get("is_data", False)
        sh = d.get("sharding")
        v.sharding = tuple(sh) if sh is not None else None
        v.seq_len_var = d.get("seq_len_var")
        v.wire_codec = d.get("wire_codec")
        return v

    def __repr__(self):
        return (f"Var({self.name}: {self.dtype}{list(self.shape)}"
                f"{' param' if self.is_parameter else ''}"
                f"{' persist' if self.persistable else ''})")


class OpDesc:
    """One operation: named input/output slots -> variable names, plus
    JSON-serializable attrs."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type: str, inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def to_dict(self) -> dict:
        return {"type": self.type, "inputs": self.inputs, "outputs": self.outputs,
                "attrs": self.attrs}

    @staticmethod
    def from_dict(d: dict) -> "OpDesc":
        return OpDesc(d["type"], d["inputs"], d["outputs"], d["attrs"])

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{outs}}} = {self.type}({ins})"


class Block:
    """Ordered op list + var table; nested via parent_idx."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []

    # -- vars ---------------------------------------------------------------
    def create_var(self, name: Optional[str] = None, **kwargs) -> VarDesc:
        if name is None:
            name = unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        v = VarDesc(name, **kwargs)
        self.vars[name] = v
        self.program.invalidate_cache()
        return v

    def var(self, name: str) -> VarDesc:
        """Find var in this block or its ancestors."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = self.program.blocks[b.parent_idx] if b.parent_idx >= 0 else None
        raise KeyError(f"variable {name!r} not found in block {self.idx} or ancestors")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    # -- ops ----------------------------------------------------------------
    def append_op(self, type: str, inputs: Optional[Dict[str, Any]] = None,
                  outputs: Optional[Dict[str, Any]] = None,
                  attrs: Optional[Dict[str, Any]] = None) -> OpDesc:
        """Append an op; slot values may be names, VarDescs, or lists
        thereof. Runs the op's shape inference at once."""
        def canon(slots):
            out = {}
            for k, v in (slots or {}).items():
                if not isinstance(v, (list, tuple)):
                    v = [v]
                out[k] = [x.name if isinstance(x, VarDesc) else x for x in v]
            return out

        op = OpDesc(type, canon(inputs), canon(outputs), attrs)
        scope_tag = current_remat_scope()
        if scope_tag is not None:
            op.attrs.setdefault("remat_scope", scope_tag)
            pol = current_remat_policy()
            if pol is not None:
                op.attrs.setdefault("remat_policy", pol)
        self.ops.append(op)
        self.program.invalidate_cache()
        from .registry import get_op  # local import to avoid a cycle
        impl = get_op(type)
        if impl is not None and impl.infer_shape is not None:
            impl.infer_shape(op, self)
        return op

    def to_dict(self) -> dict:
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [o.to_dict() for o in self.ops]}

    def all_parameters(self) -> List[VarDesc]:
        return [v for v in self.vars.values() if v.is_parameter]


class Program:
    """A computation description: blocks of ops over named vars."""

    def __init__(self):
        self._fp_cache: Optional[str] = None
        self.blocks: List[Block] = [Block(self, 0)]
        self._seed: Optional[int] = None
        self._block_stack: List[int] = [0]
        # mixed precision: recorded as in the JAX package; the port's
        # lowering runs float32 only and refuses a program that sets it
        self._amp_dtype: Optional[str] = None

    @property
    def amp_dtype(self) -> Optional[str]:
        return self._amp_dtype

    @amp_dtype.setter
    def amp_dtype(self, value: Optional[str]):
        self._amp_dtype = value
        self.invalidate_cache()

    def invalidate_cache(self):
        """Drop the memoized fingerprint after a structural mutation.
        Block.append_op/create_var call it; a pass that edits descriptors
        in place must call it itself."""
        self._fp_cache = None

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._block_stack[-1]]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # -- transforms ---------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy; for_test sets every op's is_test attr."""
        p = Program.from_dict(self.to_dict())
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    if op.type == "dropout":
                        op.attrs["is_test"] = True
        p._seed = self._seed
        return p

    def prune(self, targets: Sequence[str], feeds: Sequence[str] = ()
              ) -> "Program":
        """A clone that keeps only the block-0 ops the targets need (and
        ops flagged __side_effect__); sub-blocks of kept ops stay whole."""
        p = self.clone()
        blk = p.global_block
        needed = set(targets)
        kept: List[OpDesc] = []
        sub_names_union: set = set()
        for op in reversed(blk.ops):
            if op.type in ("feed", "fetch"):
                continue
            if set(op.output_names()) & needed or \
                    op.attrs.get("__side_effect__", False):
                kept.append(op)
                needed |= set(op.input_names())
                names = sub_block_var_names(p, op)
                needed |= names
                sub_names_union |= names
        kept.reverse()
        blk.ops = kept
        used = set(feeds) | set(targets) | sub_names_union
        for op in kept:
            used |= set(op.input_names()) | set(op.output_names())
        blk.vars = {n: v for n, v in blk.vars.items() if n in used}
        p.invalidate_cache()
        return p

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": 1, "seed": self._seed, "amp_dtype": self._amp_dtype,
                "blocks": [b.to_dict() for b in self.blocks]}

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p._seed = d.get("seed")
        p._amp_dtype = d.get("amp_dtype")
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                b.vars[vd["name"]] = VarDesc.from_dict(vd)
            b.ops = [OpDesc.from_dict(od) for od in bd["ops"]]
            p.blocks.append(b)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        return p

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def fingerprint(self) -> str:
        """Content hash of the IR, memoized until invalidate_cache()."""
        if self._fp_cache is None:
            self._fp_cache = hashlib.sha256(
                self.to_json().encode()).hexdigest()[:16]
        return self._fp_cache

    def __str__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for v in b.vars.values():
                lines.append(f"  {v!r}")
            for op in b.ops:
                lines.append(f"  {op!r}")
        return "\n".join(lines)

    # seed of the program's random ops
    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, s):
        self._seed = s


# ---------------------------------------------------------------------------
# Default programs
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, p
    return prev


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, p
    return prev


class program_guard:
    """`with program_guard(main, startup):` — scoped default programs."""

    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.prev_main = switch_main_program(self.main)
        if self.startup is not None:
            self.prev_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self.prev_main)
        if self.startup is not None:
            switch_startup_program(self.prev_startup)
        return False
