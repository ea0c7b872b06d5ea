"""Struct helper for the port's config and state containers.

The JAX package registers frozen dataclasses as pytrees so ``jit`` can
thread them through scans.  PyTorch runs eagerly, so the port's configs
are plain frozen dataclasses with tensor leaves and a ``replace`` for
functional updates.
"""
from __future__ import annotations

import dataclasses
from typing import Any


class Struct:
    """Mixin for ``@dataclasses.dataclass(frozen=True)`` containers."""

    def replace(self, **changes: Any):
        return dataclasses.replace(self, **changes)
