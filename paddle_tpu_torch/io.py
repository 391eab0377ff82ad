"""Persistence: vars, inference models, serving artifacts and the decode
bundle, and weights across the two packages.

Counterpart of ``paddle_tpu/io.py``:

* ``save_vars`` / ``load_vars`` (the per-var layout: one ``<name>.npy``
  a var, ``/`` written as ``__``), ``save_persistables`` /
  ``load_persistables``;
* ``get_inference_program``, ``save_inference_model`` and
  ``load_inference_model``: ``__model__.json`` (the pruned ``for_test``
  program's dict, the feed and fetch names) beside the persistables. The
  IR is the JAX package's field for field, so a directory that the JAX
  package's ``save_inference_model`` wrote loads here. The directory
  gets a crc32 manifest (``resilience/manifest.py``), verified on
  ``load_inference_model`` and ``load_persistables`` (``PT_CKPT_VERIFY``,
  on by default);
* checkpoints: ``save_checkpoint`` writes a serial dir
  (``checkpoint_<n>``: the persistables, ``trainer_<id>.json``, the
  manifest), then the ``_SUCCESS`` marker bound to the manifest, then
  scrolls old serials away; ``get_latest_checkpoint_serial`` verifies
  and quarantines a corrupt serial and falls back to an older one;
  ``load_checkpoint`` restores a serial and returns its trainer args.
  The layout and the manifests are the JAX package's, so a checkpoint
  either package wrote resumes in the other. Multi-host saves and plan
  stamps are not ported and raise;
* ``export_serving_model`` / ``load_serving_model``: the serving
  artifact. The JAX package's holds StableHLO executables, which PyTorch
  cannot load; the port's ``serving.json`` has the JAX schema (``feeds``,
  ``fetch_names``, ``fetches`` with ``batch_major``, ``batch_size``,
  ``buckets``, ``var_dims``) plus a ``format`` tag (``FORMAT``) and
  ``programs``: one program file a bucket, in bucket order (buckets may
  share one), where the JAX bucket names its ``.stablehlo`` file. The
  bucket entries themselves are the JAX ones without ``file``. The
  persistables go beside the programs as ``.npy`` files. Loading a JAX
  artifact raises ``ValueError``;
* ``export_decode_model``: a serving artifact whose buckets are the
  prefill programs ``models.transformer.transformer_lm(...,
  pos_table_len=max_context, collect_kv=kvs)`` builds, fetching the
  logits and every layer's K/V (the JAX fetch roles), the decode-step
  program ``models.transformer.transformer_decode_step`` builds (pruned,
  ``for_test``, in ``decode.json``, which the top-level
  ``decode_program`` names, where the JAX bundle's ``decode`` section
  names its ``.stablehlo`` file), plus the JAX ``decode`` section.
  ``ServingEngine.load_model`` serves its prefill side unchanged;
  ``load_decode_bundle``, DecodeModel's one loader, gives that prefill
  side and the step program over the same weight tensors.

``params_from_numpy`` and ``scope_from_numpy`` take the JAX package's
state as numpy arrays by name: the parameters of a model, or the whole
persistable state of a trained program as a port ``Scope``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.lowering import build_step_fn
from .core.program import (Program, VarDesc, default_main_program,
                           program_guard, unique_name_guard)
from .core.scope import Scope, global_scope
from .core.types import (device_dtype, host_array, normalize_dtype,
                         resolve_device, torch_dtype)
from .models.transformer import (CONFIG_KEYS, param_shapes,
                                 transformer_decode_step, transformer_lm)
from .resilience import faults
from .resilience import manifest as _manifest
from .resilience.faults import FaultInjected
from .resilience.manifest import VerificationError as _VerificationError
from .resilience.retry import RetryPolicy, retry_call

__all__ = ["FORMAT", "MODEL_FILENAME", "params_from_numpy",
           "scope_from_numpy", "save_vars", "load_vars",
           "save_persistables", "load_persistables", "get_inference_program",
           "save_inference_model", "load_inference_model",
           "export_serving_model", "load_serving_model", "ServingProgram",
           "DECODE_FILENAME",
           "read_serving_meta", "export_decode_model", "load_decode_bundle",
           "save_checkpoint", "load_checkpoint", "clean_checkpoint",
           "get_latest_checkpoint_serial", "CheckpointCorruptError"]

#: format tag of a port serving artifact's serving.json (decode bundles
#: included: a decode bundle is a serving artifact with a decode section)
FORMAT = "paddle_tpu_torch.serving/1"
#: the inference model's program file, as the JAX package names it
MODEL_FILENAME = "__model__.json"
#: the decode bundle's step program file
DECODE_FILENAME = "decode.json"
SUCCESS_MARK_FILENAME = "_SUCCESS"
CHECKPOINT_PREFIX = "checkpoint"


class CheckpointCorruptError(_VerificationError):
    """An explicitly requested checkpoint (or an inference dir) failed
    manifest verification. Auto-selection never raises it: it falls back
    to the newest serial that verifies, quarantining the corrupt one."""


#: transient-FS retry for checkpoint reads; a missing var file and an
#: integrity failure fail the same way every time and are not retried
_LOAD_RETRY = RetryPolicy(
    retries=2, base_delay=0.05, max_delay=0.5,
    retry_on=lambda e: isinstance(e, OSError)
    and not isinstance(e, (FileNotFoundError, _VerificationError)))


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` in its device dtype (64-bit
    narrowed, as the JAX package runs with x64 off)."""
    a = np.array(a, copy=True)
    return torch.from_numpy(a).to(device=device,
                                  dtype=torch_dtype(normalize_dtype(a.dtype)))


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      model_cfg: Dict) -> Dict[str, torch.Tensor]:
    """{JAX parameter name: array} -> {name: float32 CPU tensor}, checked
    against the configuration: a missing name, an extra name or a wrong
    shape raises ValueError."""
    want = param_shapes(model_cfg)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    if missing or extra:
        raise ValueError(f"parameters do not match the model: missing "
                         f"{missing}, extra {extra}")
    out = {}
    for name, shape in want.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != shape:
            raise ValueError(f"parameter {name!r} has shape {a.shape}, the "
                             f"model wants {shape}")
        a = np.ascontiguousarray(a, dtype=np.float32)
        out[name] = torch.from_numpy(a if a.flags.writeable else a.copy())
    return out


def scope_from_numpy(arrays: Mapping[str, np.ndarray], device=None
                     ) -> Scope:
    """{var name: array} -> a Scope of tensors on `device` (the first CUDA
    device by default), each in its device dtype (64-bit narrowed). Feed
    it the JAX scope's persistable vars to start both packages from one
    state."""
    device = resolve_device(device)
    scope = Scope()
    for name, a in arrays.items():
        scope.set_var(name, _tensor(a, device))
    return scope


# ---------------------------------------------------------------------------
# save/load vars (the per-var layout)
# ---------------------------------------------------------------------------

def _var_path(dirname: str, name: str) -> str:
    return os.path.join(dirname, name.replace("/", "__") + ".npy")


def _select_vars(program: Program, vars, predicate) -> List[VarDesc]:
    if vars is None:
        vars = [v for v in program.list_vars()
                if (predicate or (lambda v: v.persistable))(v)]
    return [program.global_block.var(v) if isinstance(v, str) else v
            for v in vars]


def _executor_device(executor) -> torch.device:
    return executor.device if executor is not None else resolve_device()


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save to a temp name, then rename: a crash leaves the previous
    file or none, never half of one (the fault sites io_crash and
    io_write_truncate make both cases on purpose)."""
    faults.crash_point("io_crash")
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    hit = faults.fire("io_write_truncate")
    if hit is not None:
        # a torn write: half the bytes reach the final name, then the
        # process "dies" (what the manifest exists to catch)
        size = os.path.getsize(tmp)
        with open(tmp, "r+b") as f:
            f.truncate(size // 2)
        os.replace(tmp, path)
        raise FaultInjected("io_write_truncate", hit)
    os.replace(tmp, path)


def _verify_dir_or_raise(dirname: str, what: str,
                         verify: Optional[bool] = None) -> None:
    """Verify a directory that has a manifest (`verify`: None follows
    PT_CKPT_VERIFY, on by default); a corrupt one raises."""
    if verify is None:
        verify = _manifest.verify_on_load()
    if verify and _manifest.read_manifest(dirname) is not None:
        status, problems = _manifest.verify_dir(dirname)
        if status == "corrupt":
            raise CheckpointCorruptError(
                f"{what} {dirname!r} failed manifest verification: "
                f"{'; '.join(problems[:5])}")


def save_vars(executor=None, dirname: str = "", main_program=None,
              vars=None, predicate=None, filename=None, scope=None):
    """One ``<name>.npy`` a var (the persistable vars by default), each
    written atomically. The combined single-file layout (`filename`) is
    not ported."""
    if filename is not None:
        raise NotImplementedError("save_vars(filename=...): the combined "
                                  "single-file layout is not ported")
    program = main_program or default_main_program()
    scope = scope or global_scope()
    values = {v.name: scope.find_var(v.name)
              for v in _select_vars(program, vars, predicate)}
    absent = [n for n, val in values.items() if val is None]
    if absent:
        raise ValueError(
            f"save_vars: {len(absent)} variable(s) have no value in the "
            f"scope (run the startup program first?): {absent[:5]}"
            f"{'...' if len(absent) > 5 else ''}")
    os.makedirs(dirname, exist_ok=True)
    for n, val in values.items():
        _atomic_save(_var_path(dirname, n), host_array(val))


def load_vars(executor=None, dirname: str = "", main_program=None,
              vars=None, predicate=None, filename=None, scope=None):
    """Read the per-var layout into `scope` on the executor's device (the
    first CUDA device without an executor). A bfloat16 var is narrowed
    back from its float32 file."""
    if filename is not None:
        raise NotImplementedError("load_vars(filename=...): the combined "
                                  "single-file layout is not ported")
    program = main_program or default_main_program()
    scope = scope or global_scope()
    device = _executor_device(executor)
    missing = []
    for v in _select_vars(program, vars, predicate):
        path = _var_path(dirname, v.name)
        if not os.path.exists(path):
            missing.append(v.name)
            continue
        t = _tensor(np.load(path), device)
        if v.dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        scope.set_var(v.name, t)
    if missing:
        raise FileNotFoundError(
            f"load_vars: no saved file for {len(missing)} variable(s) in "
            f"{dirname!r}: {missing[:5]}{'...' if len(missing) > 5 else ''}")


def save_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None):
    return save_vars(executor, dirname, main_program, None, None, filename,
                     scope)


def load_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None, verify: Optional[bool] = None):
    """load_vars of the persistables. A directory with a manifest is
    verified first (`verify`: None follows PT_CKPT_VERIFY, on by
    default); a corrupt one raises CheckpointCorruptError."""
    _verify_dir_or_raise(dirname, "persistables dir", verify)
    return load_vars(executor, dirname, main_program, None, None, filename,
                     scope)


# ---------------------------------------------------------------------------
# inference models
# ---------------------------------------------------------------------------

def _names(target_vars) -> List[str]:
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return [t.name if isinstance(t, VarDesc) else t for t in target_vars]


def get_inference_program(target_vars, main_program=None) -> Program:
    main_program = main_program or default_main_program()
    return main_program.clone(for_test=True).prune(
        targets=_names(target_vars))


def _write_model(dirname: str, program: Program, feed_names, fetch_names,
                 filename: str = MODEL_FILENAME) -> None:
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, filename), "w") as f:
        json.dump({"program": program.to_dict(),
                   "feed_names": list(feed_names),
                   "fetch_names": list(fetch_names)}, f)


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars, executor=None, main_program=None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None, scope=None):
    """The pruned, ``for_test`` program and its persistables, then the
    directory's manifest. Returns the fetch names."""
    main_program = main_program or default_main_program()
    target_names = _names(target_vars)
    pruned = main_program.clone(for_test=True).prune(
        targets=target_names, feeds=feeded_var_names)
    _write_model(dirname, pruned, feeded_var_names, target_names,
                 model_filename or MODEL_FILENAME)
    save_persistables(executor, dirname, pruned, filename=params_filename,
                      scope=scope)
    _manifest.write_manifest(dirname, layout="inference")
    return target_names


def load_inference_model(dirname: str, executor=None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None, scope=None):
    """(program, feed names, fetch vars); the persistables go into
    `scope` on the executor's device. A directory with a manifest is
    verified first (PT_CKPT_VERIFY); a corrupt one raises
    CheckpointCorruptError."""
    _verify_dir_or_raise(dirname, "inference model dir")
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope, verify=False)
    fetch_vars = [program.global_block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


# ---------------------------------------------------------------------------
# serving artifacts
# ---------------------------------------------------------------------------

def _state_names(program: Program) -> List[str]:
    """The persistable vars the program's ops read."""
    block = program.global_block
    read = {n for op in block.ops for n in op.input_names()}
    return sorted(n for n in read
                  if block.has_var(n) and block.var(n).persistable)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def _meta_limit(e: Exception) -> bool:
    """Whether `e` is the meta device's own limit (an op without a Meta
    kernel, a value read off a tensor that holds none), not the
    program's fault."""
    return (isinstance(e, NotImplementedError)
            or (isinstance(e, (RuntimeError, TypeError))
                and "meta" in str(e).lower()))


def _run_specs(program: Program, feed_names, fetch_names, state,
               feeds) -> List[Tuple[List[int], str]]:
    """[(shape, dtype)] of each fetch for zero feeds of the given
    [(shape, dtype)]: the program run on the meta device (shapes only,
    no data), or on the CPU where an op has no meta version. Any other
    error is the program's and is raised."""
    for dev in (torch.device("meta"), torch.device("cpu")):
        st = {n: (torch.empty(v.shape, dtype=v.dtype, device=dev)
                  if dev.type == "meta" else v.detach().to(dev))
              for n, v in state.items()}
        fd = {n: torch.zeros(s, dtype=torch_dtype(d), device=dev)
              for n, (s, d) in zip(feed_names, feeds)}
        step, _ = build_step_fn(program, list(feed_names), list(fetch_names),
                                sorted(st), dev)
        try:
            with torch.inference_mode():
                outs, _ = step(st, fd, None)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if dev.type == "meta" and _meta_limit(e):
                continue
            raise
        return [([int(x) for x in o.shape], _dtype_name(o)) for o in outs]
    raise AssertionError("unreachable: the CPU run returns or raises")


def _feed_templates(program: Program, feed_names, batch_size: int,
                    length_buckets):
    """Per feed (name, shape with the batch dim pinned, device dtype,
    batch-major), and {feed: its length dims}: the leading -1 is
    layers.data's batch dim; any other -1 needs a bucket bound."""
    templates, var_dims = [], {}
    for name in feed_names:
        var = program.global_block.var(name)
        dims = tuple(int(s) for s in var.shape)
        shape = list(dims)
        if shape and shape[0] == -1:
            shape[0] = batch_size
        lens = [i for i, s in enumerate(shape) if s < 0]
        if lens and not length_buckets:
            raise ValueError(
                f"export_serving_model: feed {name!r} has symbolic dims "
                f"{dims}; a serving artifact needs fully static shapes — "
                "pad or declare the feed with concrete sizes, or pass "
                "length_buckets=(...) to export one bucket per pad bound")
        if lens:
            var_dims[name] = lens
        templates.append((name, shape, device_dtype(var.dtype),
                          bool(dims) and dims[0] == -1))
    return templates, var_dims


def _bucket_meta(program: Program, fetch_names, roles, state, templates,
                 batch_size: int, length: Optional[int]) -> dict:
    """One bucket's feed and fetch specs. A fetch is batch-major when its
    leading dim is the batch at batch_size and at batch_size + 1 (a
    fetch whose leading dim merely coincides with the batch is not).
    Where the program cannot run at batch_size + 1 (a shape error) and a
    fetch's leading dim is batch_size, the export is refused: the JAX
    package guesses batch-major there, and a wrong guess would scatter
    one request's rows to others."""
    feeds_meta, example, alt = [], [], []
    for name, shape, dt, is_batch in templates:
        concrete = [length if s < 0 else s for s in shape]
        example.append((concrete, dt))
        bumped = list(concrete)
        if is_batch:
            bumped[0] = batch_size + 1
        alt.append((bumped, dt))
        feeds_meta.append({"name": name, "shape": concrete, "dtype": dt,
                           "batch_major": is_batch})
    feed_names = [t[0] for t in templates]
    specs = _run_specs(program, feed_names, fetch_names, state, example)
    try:
        alt_specs = _run_specs(program, feed_names, fetch_names, state, alt)
        pinned = None
    except RuntimeError as e:  # a shape error: the program pins the batch
        alt_specs, pinned = None, e
    fetch_meta = []
    for j, (role, (shape, dt)) in enumerate(zip(roles, specs)):
        bm = bool(shape) and shape[0] == batch_size
        if bm and alt_specs is None:
            raise ValueError(
                f"export: fetch {role!r} has the batch size {batch_size} "
                f"as its leading dim, and the program does not run at "
                f"batch {batch_size + 1} ({pinned}), so whether the dim "
                "is the batch cannot be told; build the program with a "
                "batch dim of -1")
        if bm:
            a = alt_specs[j][0]
            bm = bool(a) and a[0] == batch_size + 1
        fetch_meta.append({"name": role, "shape": shape, "dtype": dt,
                           "batch_major": bm})
    return {"length": length, "feeds": feeds_meta, "fetches": fetch_meta}


def _write_serving_json(dirname: str, meta: dict) -> None:
    with open(os.path.join(dirname, "serving.json"), "w") as f:
        json.dump(dict(meta, format=FORMAT), f)


def export_serving_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars, executor=None, main_program=None,
                         scope: Optional[Scope] = None, batch_size: int = 1,
                         length_buckets: Optional[Sequence[int]] = None):
    """Serving export: the program pruned to the targets (``for_test``)
    as ``__model__.json``, its persistables from `scope` as ``.npy``, and
    serving.json. Shape-specialized to `batch_size`, as the JAX artifact.

    `length_buckets`: pad bounds for feeds with a symbolic (non-batch)
    length dim; one bucket a bound, every symbolic length dim pinned to
    it, all buckets on the one program (the port runs it at any shape).
    Without it a symbolic non-batch dim is an error, as in the JAX
    package. serving.json records, per bucket, the feed and fetch specs
    (name / shape / dtype / batch_major), the fetches' from a run of the
    program on the meta device."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    target_names = _names(target_vars)
    feeds = list(feeded_var_names)
    pruned = main_program.clone(for_test=True).prune(
        targets=target_names, feeds=feeds)
    state = {n: scope.find_var(n) for n in _state_names(pruned)}
    absent = sorted(n for n, v in state.items() if v is None)
    if absent:
        raise ValueError(f"export_serving_model: {absent} have no value in "
                         "the scope (run the startup program first?)")
    templates, var_dims = _feed_templates(pruned, feeds, batch_size,
                                          length_buckets)
    bounds = ([None] if not (var_dims and length_buckets)
              else sorted(int(b) for b in length_buckets))
    buckets = [_bucket_meta(pruned, target_names, target_names, state,
                            templates, batch_size, bound)
               for bound in bounds]
    _write_model(dirname, pruned, feeds, target_names)
    save_vars(None, dirname, pruned, vars=sorted(state), scope=scope)
    base = buckets[-1]
    _write_serving_json(dirname, {
        "feeds": base["feeds"], "fetch_names": target_names,
        "fetches": base["fetches"], "batch_size": batch_size,
        "buckets": buckets, "var_dims": var_dims,
        "programs": [MODEL_FILENAME] * len(buckets)})
    return dirname


def read_serving_meta(dirname: str) -> dict:
    """serving.json of a port artifact; a JAX (StableHLO) artifact, or
    anything else without the port's format tag, raises ValueError."""
    with open(os.path.join(dirname, "serving.json")) as f:
        meta = json.load(f)
    fmt = meta.get("format")
    if fmt != FORMAT:
        what = (f"format {fmt!r}" if fmt is not None else
                "a JAX StableHLO (jax.export) artifact, no format tag")
        raise ValueError(
            f"{dirname} is not a {FORMAT} artifact ({what}); the port "
            "cannot run StableHLO — export it with "
            "paddle_tpu_torch.io.export_serving_model or "
            "export_decode_model")
    return meta


class ServingProgram:
    """One program of a serving artifact, lowered once onto `device`
    (core/lowering.py ``build_step_fn``), its persistables bound there
    once (shared across the artifact's programs through `state_cache`).
    A call runs one step under ``torch.inference_mode()``: no state is
    written back and no feed is prepared beyond the caller's tensors."""

    def __init__(self, dirname: str, filename: str, device,
                 state_cache: Optional[Dict[str, torch.Tensor]] = None):
        with open(os.path.join(dirname, filename)) as f:
            d = json.load(f)
        self.program = Program.from_dict(d["program"])
        self.feed_names = list(d["feed_names"])
        self.fetch_names = list(d["fetch_names"])
        self.device = torch.device(device)
        cache = {} if state_cache is None else state_cache
        for n in _state_names(self.program):
            if n not in cache:
                path = _var_path(dirname, n)
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"{dirname}: the program {filename} reads {n!r}, "
                        f"which has no {os.path.basename(path)}")
                cache[n] = _tensor(np.load(path), self.device)
        self.state = {n: cache[n] for n in _state_names(self.program)}
        self._step, _ = build_step_fn(self.program, self.feed_names,
                                      self.fetch_names, sorted(self.state),
                                      self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    def __call__(self, feeds: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode():
            fetches, _ = self._step(self.state, feeds, self._gen)
        return fetches


def load_serving_model(dirname: str, device=None):
    """Load a serving artifact: returns (predict_fn, feed_names,
    fetch_names); predict_fn(*arrays) runs the largest bucket's program
    at its shape on `device` (the first CUDA device by default) and
    returns the fetches as numpy arrays. Unlike ServingEngine, it serves
    artifacts with static (non-batch-major) feeds too."""
    meta = read_serving_meta(dirname)
    device = resolve_device(device)
    prog = ServingProgram(dirname, meta["programs"][-1], device)
    feeds = meta["buckets"][-1]["feeds"]

    def predict(*arrays):
        fd = {m["name"]: torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.dtype(m["dtype"]))).to(device)
            for m, a in zip(feeds, arrays)}
        return [o.cpu().numpy() for o in prog(fd)]

    return predict, [m["name"] for m in meta["feeds"]], meta["fetch_names"]


# ---------------------------------------------------------------------------
# the decode bundle
# ---------------------------------------------------------------------------

def export_decode_model(dirname: str, model_cfg: Dict, *,
                        params: Mapping[str, np.ndarray],
                        length_buckets: Sequence[int] = (64, 128),
                        slots: Optional[int] = None,
                        block_size: Optional[int] = None,
                        pool_blocks: Optional[int] = None,
                        prefill_batch_size: int = 1,
                        eos_id: Optional[int] = None) -> str:
    """Write the decode bundle for a transformer_lm configuration: one
    prefill program a length bucket (``transformer_lm`` on ``src_ids
    [bound]`` with ``max_len = pos_table_len = max_context`` and
    ``collect_kv``, fetching the logits and every layer's K/V under the
    JAX roles ``logits``, ``k_i``, ``v_i``), the decode step
    (``transformer_decode_step``, fetching the logits and every layer's
    written pools) as ``decode.json``, the parameters as ``.npy``, and
    serving.json with the JAX bucket specs and ``decode`` section.

    model_cfg: vocab_size, n_layers, d_model, n_heads, d_ff, max_context.
    params: {JAX parameter name: array} (checked by params_from_numpy).
    slots / block_size / pool_blocks default from PT_DECODE_MAX_SLOTS /
    PT_DECODE_BLOCK_SIZE / PT_DECODE_POOL_BLOCKS (8 / 16 / 64), as in the
    JAX package. Block 0 of the pool is the reserved null block."""
    from .layers import data
    from .serving.batcher import env_int

    slots = slots or env_int("PT_DECODE_MAX_SLOTS", 8)
    block_size = block_size or env_int("PT_DECODE_BLOCK_SIZE", 16)
    pool_blocks = pool_blocks or env_int("PT_DECODE_POOL_BLOCKS", 64)
    cfg = {k: int(model_cfg[k]) for k in CONFIG_KEYS}
    vocab, n_layers, d_model, n_heads = (cfg["vocab_size"], cfg["n_layers"],
                                         cfg["d_model"], cfg["n_heads"])
    max_context = cfg["max_context"]
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads "
                         f"{n_heads}")
    head_dim = d_model // n_heads
    buckets = sorted(int(b) for b in length_buckets)
    if not buckets or buckets[-1] > max_context:
        raise ValueError(f"length_buckets {buckets} must be non-empty and "
                         f"bounded by max_context {max_context}")
    if pool_blocks < 2:
        raise ValueError("pool_blocks must be >= 2 (block 0 is the "
                         "reserved null block)")
    state = params_from_numpy(params, cfg)
    max_blocks_per_seq = -(-max_context // block_size)
    ids_dt = device_dtype("int64")
    i32 = "int32"
    B = prefill_batch_size

    os.makedirs(dirname, exist_ok=True)
    for name, t in state.items():
        np.save(_var_path(dirname, name), t.numpy())

    kv_roles = [(f"k_{i}", f"v_{i}") for i in range(n_layers)]
    fetch_roles = ["logits"] + [n for pair in kv_roles for n in pair]
    buckets_meta, programs = [], []
    for bound in buckets:
        main, kvs = Program(), []
        with unique_name_guard(), program_guard(main, Program()):
            src = data("src_ids", [bound], dtype="int64")
            logits = transformer_lm(
                src, vocab, n_layers=n_layers, d_model=d_model,
                n_heads=n_heads, d_ff=cfg["d_ff"], max_len=max_context,
                pos_table_len=max_context, collect_kv=kvs)
        targets = [logits.name] + [n for k, v in kvs
                                   for n in (k.name, v.name)]
        pruned = main.clone(for_test=True).prune(targets=targets,
                                                 feeds=["src_ids"])
        templates, _ = _feed_templates(pruned, ["src_ids"], B, None)
        buckets_meta.append(_bucket_meta(pruned, targets, fetch_roles,
                                         state, templates, B, bound))
        programs.append(f"prefill_len{bound}.json")
        _write_model(dirname, pruned, ["src_ids"], targets, programs[-1])

    main = Program()
    with unique_name_guard(), program_guard(main, Program()):
        dlogits, pool_outs, dec_feed_names = transformer_decode_step(
            vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            d_ff=cfg["d_ff"], max_context=max_context, slots=slots,
            block_size=block_size, pool_blocks=pool_blocks,
            max_blocks_per_seq=max_blocks_per_seq)
    dec_targets = [dlogits.name] + [n for ko, vo in pool_outs
                                    for n in (ko.name, vo.name)]
    _write_model(dirname, main.clone(for_test=True).prune(
        targets=dec_targets, feeds=dec_feed_names), dec_feed_names,
        dec_targets, DECODE_FILENAME)

    pool_shape = [pool_blocks, block_size, n_heads, head_dim]
    dec_feeds = [{"name": "token_ids", "shape": [slots], "dtype": ids_dt},
                 {"name": "context_lens", "shape": [slots], "dtype": i32},
                 {"name": "block_tables",
                  "shape": [slots, max_blocks_per_seq], "dtype": i32}]
    dec_fetches = [{"name": "logits", "shape": [slots, vocab],
                    "dtype": "float32"}]
    for i in range(n_layers):
        dec_feeds += [{"name": f"{kv}_cache_{i}", "shape": pool_shape,
                       "dtype": "float32"} for kv in ("k", "v")]
        dec_fetches += [{"name": f"{kv}_cache_out_{i}", "shape": pool_shape,
                         "dtype": "float32"} for kv in ("k", "v")]
    base = buckets_meta[-1]
    _write_serving_json(dirname, {
        "feeds": base["feeds"], "fetch_names": fetch_roles,
        "fetches": base["fetches"], "batch_size": B,
        "buckets": buckets_meta, "var_dims": {"src_ids": [1]},
        "programs": programs, "decode_program": DECODE_FILENAME,
        "decode": {
            "feeds": dec_feeds, "fetches": dec_fetches,
            "slots": slots, "block_size": block_size,
            "pool_blocks": pool_blocks,
            "max_blocks_per_seq": max_blocks_per_seq,
            "max_context": max_context, "n_layers": n_layers,
            "n_heads": n_heads, "head_dim": head_dim,
            "vocab_size": vocab, "eos_id": eos_id,
            "prefill_roles": {"logits": "logits",
                              "kv": [list(p) for p in kv_roles]},
            "model_cfg": cfg,
        },
    })
    return dirname


def load_decode_bundle(dirname: str, device=None, *, warmup: bool = False):
    """(serving.json metadata, the prefill side as a
    ``serving.registry.ModelVersion`` over the bundle's prefill programs,
    the decode step as a ``ServingProgram`` over that version's weight
    tensors, shared and not copied), on `device` (the first CUDA device
    by default). The one loader of a decode bundle: DecodeModel loads
    through it. `warmup` runs a zero batch through every prefill
    bucket. A bundle without a step program (written before the step
    was one) raises ValueError."""
    from .serving.registry import ModelVersion

    device = resolve_device(device)
    meta = read_serving_meta(dirname)
    if not meta.get("decode"):
        raise ValueError(f"{dirname} has no decode section in serving.json "
                         "— export it with "
                         "paddle_tpu_torch.io.export_decode_model")
    if not meta.get("decode_program"):
        raise ValueError(f"{dirname} has no decode-step program; re-export "
                         "it with paddle_tpu_torch.io.export_decode_model")
    prefill = ModelVersion.load(dirname, version=1, device=device,
                                warmup=warmup)
    step = ServingProgram(dirname, meta["decode_program"], device,
                          prefill.state)
    return meta, prefill, step


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _serial_dir(checkpoint_dir: str, serial: int) -> str:
    return os.path.join(checkpoint_dir, f"{CHECKPOINT_PREFIX}_{serial}")


def _committed_serials(checkpoint_dir: str) -> List[int]:
    out = []
    for name in os.listdir(checkpoint_dir):
        m = re.fullmatch(rf"{CHECKPOINT_PREFIX}_(\d+)", name)
        if m and os.path.exists(os.path.join(checkpoint_dir, name,
                                             SUCCESS_MARK_FILENAME)):
            out.append(int(m.group(1)))
    return sorted(out, reverse=True)


def get_latest_checkpoint_serial(checkpoint_dir: str,
                                 verify: Optional[bool] = None) -> int:
    """The newest committed serial; by default (PT_CKPT_VERIFY) the
    newest that also passes manifest verification. A committed serial
    that fails is quarantined (renamed ``checkpoint_N.corrupt``, never
    deleted) and the scan falls back to the next older one. A serial
    without a manifest verifies as legacy and is accepted. -1: none."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return -1
    if verify is None:
        verify = _manifest.verify_on_load()
    import warnings
    for serial in _committed_serials(checkpoint_dir):
        if not verify:
            return serial
        cur = _serial_dir(checkpoint_dir, serial)
        status, problems = _manifest.verify_dir(cur, SUCCESS_MARK_FILENAME)
        if status != "corrupt":
            return serial
        dest = _manifest.quarantine(cur)
        warnings.warn(
            f"checkpoint serial {serial} in {checkpoint_dir!r} failed "
            f"manifest verification ({'; '.join(problems[:3])}"
            f"{'...' if len(problems) > 3 else ''}) — quarantined to "
            f"{dest}; falling back to the next older serial",
            stacklevel=2)
    return -1


def save_checkpoint(executor=None, checkpoint_dir: str = "",
                    trainer_id: int = 0, trainer_args: Optional[dict] = None,
                    main_program=None, max_num_checkpoints: int = 3,
                    scope=None, plan=None) -> int:
    """Write the next serial dir (the persistables and
    ``trainer_<id>.json``), its manifest, then the _SUCCESS marker bound
    to the manifest, then remove all but the newest
    `max_num_checkpoints` serials. Returns the serial. A crash before
    the marker leaves an uncommitted dir that the next save clears.
    Plan stamps (`plan`) are not ported."""
    if plan is not None:
        raise NotImplementedError("save_checkpoint(plan=...): plan stamps "
                                  "of a sharded run are not ported")
    # picking the serial reads markers only: verification is the load
    # path's duty
    serial = get_latest_checkpoint_serial(checkpoint_dir, verify=False) + 1
    cur = _serial_dir(checkpoint_dir, serial)
    if os.path.isdir(cur):
        # an uncommitted attempt's leftovers
        shutil.rmtree(cur, ignore_errors=True)
    os.makedirs(cur, exist_ok=True)
    save_persistables(executor, cur, main_program, scope=scope)
    if trainer_args:
        with open(os.path.join(cur, f"trainer_{trainer_id}.json"), "w") as f:
            json.dump(trainer_args, f)
    _manifest.write_manifest(cur, layout="checkpoint")
    faults.crash_point("commit_crash")
    marker = os.path.join(cur, SUCCESS_MARK_FILENAME)
    tmp = marker + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(_manifest.success_payload(cur))
    os.replace(tmp, marker)
    _scroll_delete(checkpoint_dir, max_num_checkpoints)
    return serial


def load_checkpoint(executor=None, checkpoint_dir: str = "",
                    serial: Optional[int] = None, main_program=None,
                    trainer_id: int = 0, scope=None,
                    verify: Optional[bool] = None,
                    expect_plan: Optional[dict] = None,
                    reshard: bool = False):
    """Restore a serial's persistables into `scope` on the executor's
    device; returns its trainer args (None without them, or without a
    serial). `serial=None` takes the newest that verifies; an explicit
    serial that fails verification raises CheckpointCorruptError.
    `verify=False` skips re-verifying a serial the caller just selected
    through get_latest_checkpoint_serial. Plan stamps (`expect_plan`,
    `reshard`) are not ported."""
    if expect_plan is not None or reshard:
        raise NotImplementedError("load_checkpoint(expect_plan=..., "
                                  "reshard=...): plan stamps of a sharded "
                                  "run are not ported")
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir)
    else:
        # an explicit serial is the caller's choice: no fallback
        _verify_dir_or_raise(_serial_dir(checkpoint_dir, serial),
                             "checkpoint serial", verify)
    if serial < 0:
        return None
    cur = _serial_dir(checkpoint_dir, serial)
    retry_call(load_persistables, executor, cur, main_program, scope=scope,
               verify=False, policy=_LOAD_RETRY)
    args_path = os.path.join(cur, f"trainer_{trainer_id}.json")
    if os.path.exists(args_path):
        with open(args_path) as f:
            return json.load(f)
    return None


def clean_checkpoint(checkpoint_dir: str, delete_dir: bool = False):
    _scroll_delete(checkpoint_dir, max_num_checkpoints=0)
    if delete_dir and os.path.isdir(checkpoint_dir) \
            and not os.listdir(checkpoint_dir):
        os.rmdir(checkpoint_dir)


def _scroll_delete(checkpoint_dir: str, max_num_checkpoints: int):
    if not os.path.isdir(checkpoint_dir):
        return
    serials = []
    for name in os.listdir(checkpoint_dir):
        m = re.fullmatch(rf"{CHECKPOINT_PREFIX}_(\d+)", name)
        if m:
            serials.append(int(m.group(1)))
    serials.sort(reverse=True)
    for s in serials[max_num_checkpoints:]:
        shutil.rmtree(_serial_dir(checkpoint_dir, s), ignore_errors=True)
