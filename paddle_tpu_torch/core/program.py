"""The Program IR.

Counterpart of ``paddle_tpu/core/program.py``: ``VarDesc``, ``OpDesc``,
``Block`` and ``Program``, the default-program machinery, unique names
and remat scopes. The IR is the JAX package's, field for field
(``to_dict`` gives the same dict), so the same build calls give the same
program in both packages: the same ops in order and the same var names
(the weight carry between them depends on it).

A Program is a description only. The port's Executor (core/executor.py)
runs it op by op through torch (core/lowering.py); there is no compile
step and so no fingerprint cache, and no clone, prune or JSON loading,
which the ported slices do not use.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .types import VarKind, normalize_dtype

__all__ = ["unique_name", "reset_unique_names", "remat_scope", "VarDesc",
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
        self.blocks: List[Block] = [Block(self, 0)]
        self._seed: Optional[int] = None
        self._block_stack: List[int] = [0]
        # mixed precision: recorded as in the JAX package; the port's
        # lowering runs float32 only and refuses a program that sets it
        self.amp_dtype: Optional[str] = None

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._block_stack[-1]]

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": 1, "seed": self._seed, "amp_dtype": self.amp_dtype,
                "blocks": [b.to_dict() for b in self.blocks]}

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
