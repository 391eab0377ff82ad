"""Checkpoint manifests: per-file size + crc32, committed before _SUCCESS.

Counterpart of ``paddle_tpu/resilience/manifest.py``, byte for byte in
what it writes and reads, so a directory either package wrote verifies
in the other (the port carries its own copy: it imports nothing of the
JAX package). The _SUCCESS marker proves a save finished; the manifest
proves the bytes on disk are the bytes that were written:

  * ``write_manifest(dirname)`` digests the directory's regular files
    into ``manifest.json`` — {version, layout, files: {name: {size,
    crc32}}} — atomically;
  * the _SUCCESS marker stores the manifest file's own size and crc32
    (``success_payload`` / ``check_success``), binding marker ->
    manifest -> data;
  * ``verify_dir(dirname)`` re-digests and returns ("ok" | "legacy" |
    "corrupt", problems); "legacy" is a committed dir without a
    manifest, accepted;
  * ``quarantine(path)`` renames a corrupt dir to ``<path>.corrupt[-k]``
    so the loaders skip it and the evidence stays.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

__all__ = ["MANIFEST_FILENAME", "VerificationError", "verify_on_load",
           "write_manifest", "read_manifest", "verify_dir", "verify_file",
           "success_payload", "check_success", "quarantine"]

MANIFEST_FILENAME = "manifest.json"


def verify_on_load() -> bool:
    """The ONE reading of the PT_CKPT_VERIFY opt-out (default on) — every
    load-time verification gate (checkpoints, inference dirs, host-table
    shards) must consult the same switch."""
    return os.environ.get("PT_CKPT_VERIFY", "1").strip().lower() \
        not in ("0", "false", "never")


class VerificationError(IOError):
    """Deterministic integrity failure (manifest mismatch, mixed layouts)
    — distinct from transient OSErrors so retry layers never re-run a
    load that can only fail the same way."""


#: never digested: the manifest itself, markers, in-flight temp files
_SKIP_PREFIXES = ("_SUCCESS",)

#: _atomic_save / write_manifest temps are `<final>.tmp<pid>` — match the
#: SUFFIX only: persistable BN running stats are legitimately named
#: `batch_norm_N.tmp_0.npy` and MUST be digested (they are exactly the
#: silently-wrong-if-rotten state the manifest exists to protect)
_TMP_SUFFIX = re.compile(r"\.tmp\d*$")  # host_table uses bare ".tmp"


def _skip(name: str) -> bool:
    return (name == MANIFEST_FILENAME or name.startswith(_SKIP_PREFIXES)
            or _TMP_SUFFIX.search(name) is not None)


def _digest(path: str) -> Tuple[int, int]:
    size = 0
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
    return size, crc & 0xFFFFFFFF


def write_manifest(dirname: str, layout: str = "checkpoint",
                   extra: Optional[dict] = None) -> dict:
    """Digest every regular file in `dirname` (flat — checkpoint serial
    dirs have no nesting) into manifest.json, atomically.

    `extra` keys are merged into the manifest document (e.g. the
    checkpoint's plan stamp). Because _SUCCESS stores the manifest
    file's own size+crc32, anything merged here rides the same
    marker -> manifest -> data integrity binding for free."""
    files: Dict[str, dict] = {}
    for name in sorted(os.listdir(dirname)):
        path = os.path.join(dirname, name)
        if _skip(name) or not os.path.isfile(path):
            continue
        size, crc = _digest(path)
        files[name] = {"size": size, "crc32": crc}
    man = {"version": 1, "layout": layout, "files": files}
    if extra:
        for k, v in extra.items():
            if k in man:
                raise ValueError(f"manifest extra key {k!r} collides "
                                 "with a reserved manifest field")
            man[k] = v
    path = os.path.join(dirname, MANIFEST_FILENAME)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=0, sort_keys=True)
    os.replace(tmp, path)
    return man


def read_manifest(dirname: str) -> Optional[dict]:
    path = os.path.join(dirname, MANIFEST_FILENAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}  # unreadable/truncated manifest: corrupt, not legacy


def success_payload(dirname: str) -> str:
    """What save_checkpoint writes INTO the _SUCCESS marker: the manifest
    file's own size+crc32, binding marker -> manifest -> data."""
    size, crc = _digest(os.path.join(dirname, MANIFEST_FILENAME))
    return json.dumps({"manifest_size": size, "manifest_crc32": crc})


def check_success(dirname: str, marker_filename: str = "_SUCCESS"
                  ) -> Optional[str]:
    """Verify the marker's manifest binding. None = ok (or a legacy empty
    marker / marker without a manifest reference); else a problem."""
    path = os.path.join(dirname, marker_filename)
    if not os.path.exists(path):
        return None  # unmarked dir (e.g. inference export): nothing to bind
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError as e:
        return f"_SUCCESS unreadable: {e}"
    if not text:
        return None  # legacy marker
    try:
        ref = json.loads(text)
    except ValueError:
        return "_SUCCESS payload is not JSON"
    mpath = os.path.join(dirname, MANIFEST_FILENAME)
    if not os.path.exists(mpath):
        return "_SUCCESS references a manifest that is absent"
    size, crc = _digest(mpath)
    if (size != ref.get("manifest_size")
            or crc != ref.get("manifest_crc32")):
        return (f"manifest.json does not match _SUCCESS binding "
                f"(size {size} crc {crc} vs {ref})")
    return None


def verify_dir(dirname: str, marker_filename: str = "_SUCCESS"
               ) -> Tuple[str, List[str]]:
    """("ok" | "legacy" | "corrupt", problems). "legacy" means no
    manifest to check against (pre-manifest checkpoint): accepted."""
    problems: List[str] = []
    mproblem = check_success(dirname, marker_filename)
    if mproblem:
        return "corrupt", [mproblem]
    man = read_manifest(dirname)
    if man is None:
        return "legacy", []
    files = man.get("files")
    if not isinstance(files, dict):
        return "corrupt", ["manifest.json unreadable or malformed"]
    for name, want in sorted(files.items()):
        path = os.path.join(dirname, name)
        if not os.path.isfile(path):
            problems.append(f"{name}: listed in manifest but absent")
            continue
        size, crc = _digest(path)
        if size != want.get("size"):
            problems.append(f"{name}: size {size} != manifest "
                            f"{want.get('size')}")
        elif crc != want.get("crc32"):
            problems.append(f"{name}: crc32 {crc} != manifest "
                            f"{want.get('crc32')}")
    return ("corrupt" if problems else "ok"), problems


def verify_file(dirname: str, name: str) -> Optional[str]:
    """Check ONE file against the dir's manifest. None = ok or nothing to
    check (no manifest / file unlisted); else the problem. For loaders
    that read a single file out of a manifested dir (host_table.load)."""
    man = read_manifest(dirname)
    if not man:
        return None
    want = (man.get("files") or {}).get(name)
    if want is None:
        return None
    path = os.path.join(dirname, name)
    if not os.path.isfile(path):
        return f"{name}: listed in manifest but absent"
    size, crc = _digest(path)
    if size != want.get("size") or crc != want.get("crc32"):
        return (f"{name}: size/crc32 ({size}, {crc}) != manifest "
                f"({want.get('size')}, {want.get('crc32')})")
    return None


def quarantine(path: str) -> str:
    """Rename a corrupt dir out of the serial namespace; returns the new
    path. Never deletes — the corpse is the post-mortem evidence."""
    dest = path + ".corrupt"
    k = 0
    while os.path.exists(dest):
        k += 1
        dest = f"{path}.corrupt-{k}"
    os.rename(path, dest)
    return dest
