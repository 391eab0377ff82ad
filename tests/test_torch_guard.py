"""Guards of the port's boundary.

paddle_tpu_torch and chip_smoke.py never load JAX or any module of the JAX
package, neither by a direct import (the AST scan) nor through anything
they import (a fresh interpreter imports every module of the port and
lists what got loaded). Entry points run on the card unless the caller
asks for the CPU, so without a card a default-device entry point raises,
and chip_smoke.py exits non-zero without printing a result.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")

torch.set_num_threads(2)


def _port_sources():
    # _build/ holds what the kernels' build generates, not sources
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.relative_to(PORT).parts) + \
        [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import paddle_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(json.dumps({"imported": names, "loaded": loaded}))
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=_subprocess_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.serving.decode.engine" in report["imported"]
    assert "paddle_tpu_torch.kernels.flash_attention" in report["imported"]
    assert "paddle_tpu_torch.core.executor" in report["imported"]
    for name in ("analysis.fuse", "kernels.fused_conv", "ops.fused_ops",
                 "models.resnet", "layers.metric", "kernels.fused_lstm",
                 "ops.rnn_ops", "ops.sequence_ops", "lod", "layers.sequence",
                 "models.stacked_dynamic_lstm"):
        assert "paddle_tpu_torch." + name in report["imported"]
    assert report["loaded"] == []


def test_default_device_raises_without_a_card():
    from paddle_tpu_torch.core.types import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_default_executor_raises_without_a_card():
    import paddle_tpu_torch as pt

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor(pt.CUDAPlace(0))
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_subprocess_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
