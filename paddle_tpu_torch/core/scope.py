"""Scope: name -> tensor state between steps.

Counterpart of ``paddle_tpu/core/scope.py``. A Scope holds the
persistable vars (parameters, optimizer accumulators) as torch tensors on
the executor's device; activations never enter it. ``get_numpy`` is the
one explicit read to the host.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .types import host_array

__all__ = ["Scope", "global_scope", "scope_guard"]


class Scope:
    def __init__(self):
        self._vars: Dict[str, torch.Tensor] = {}

    def find_var(self, name: str) -> Optional[torch.Tensor]:
        return self._vars.get(name)

    def has_var(self, name: str) -> bool:
        return name in self._vars

    def set_var(self, name: str, value: torch.Tensor):
        self._vars[name] = value

    def local_var_names(self) -> Iterator[str]:
        return iter(list(self._vars))

    def get_numpy(self, name: str) -> np.ndarray:
        """Copy one var to host numpy (waits for the device); bfloat16
        widened to float32 (``types.host_array``)."""
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in scope")
        return host_array(v)


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    """`with scope_guard(scope):`"""

    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _scope_stack.pop()
        return False
