"""Per-matrix caches of derived objects, keyed on content.

Counterpart of ``tpu_sparse/utils/opcache.py``. An RCM reordering or a
transposed repack is costly set-up work worth keeping per matrix, but
keying on ``id(A)`` alone goes stale when a workflow rebinds a container's
tensors (``A.data = new``) or writes into them. JAX arrays are immutable,
so the JAX key holds each array leaf's id; torch tensors change in place,
so the key here also holds each leaf's ``_version``, which every in-place
write bumps. Entries pin weak references to the operand and its leaves,
so a recycled id never aliases a dead operand, and entries whose operand
died are dropped.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Hashable

import torch

from tpu_sparse_torch import tracing


def _leaves(A) -> tuple:
    """The tensors that make up ``A``: itself, a container's tensor fields,
    and those of its segments, in a fixed order."""
    if isinstance(A, torch.Tensor):
        return (A,)
    out = []
    for v in vars(A).values() if hasattr(A, "__dict__") else ():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple) and v and hasattr(v[0], "__dict__"):
            for seg in v:
                out.extend(_leaves(seg))
    return tuple(out)


def content_key(A, extra: Hashable = ()) -> tuple:
    """Cache key tracking the operand object, its tensor leaves and their
    in-place versions."""
    return ((id(A),) + tuple((id(t), t._version) for t in _leaves(A))
            + (extra,))


class OperandCache:
    """Small map from (matrix content, extra options) to a derived object.
    A ``name`` puts each build after a miss in the span
    ``tsp.router.build.<name>``."""

    def __init__(self, max_entries: int = 16, name: "str | None" = None):
        self._store: dict = {}
        self._max = max_entries
        self._span = None if name is None else f"tsp.router.build.{name}"

    def get_or_build(self, A, build: Callable[[], Any],
                     extra: Hashable = ()) -> Any:
        # drop entries whose operand died: their values may pin large
        # device buffers past the matrix's lifetime
        for k in [k for k, e in self._store.items() if e[0]() is None]:
            del self._store[k]
        key = content_key(A, extra)
        entry = self._store.get(key)
        if entry is not None and entry[0]() is A and all(
                r() is t for r, t in zip(entry[1], _leaves(A))):
            return entry[2]
        if self._span is None:
            value = build()
        else:
            with tracing.span(self._span):
                value = build()
        if len(self._store) >= self._max:
            self._store.clear()
        try:
            refs = tuple(weakref.ref(t) for t in _leaves(A))
            self._store[key] = (weakref.ref(A), refs, value)
        except TypeError:
            pass  # an operand that takes no weak reference: rebuilt next time
        return value


class TensorCache:
    """One derived object per live tensor, with no size limit: an entry
    goes when its tensor is freed, and a lookup misses when the tensor's
    in-place version or the caller's ``extra`` key differs from the one
    the entry was stored with (the next ``put`` replaces it). For objects
    that must live exactly as long as the tensor they derive from."""

    def __init__(self):
        self._store: dict = {}  # id(t) -> (weak ref to t, key, value)

    def __len__(self) -> int:
        return len(self._store)

    def get(self, t: torch.Tensor, extra: Hashable = ()) -> Any:
        """The object stored for ``t`` at its current version, else None."""
        entry = self._store.get(id(t))
        if (entry is not None and entry[0]() is t
                and entry[1] == (t._version, extra)):
            return entry[2]
        return None

    def put(self, t: torch.Tensor, value: Any, extra: Hashable = ()) -> None:
        key, store = id(t), self._store

        def drop(ref):
            entry = store.get(key)
            if entry is not None and entry[0] is ref:
                del store[key]

        store[key] = (weakref.ref(t, drop), (t._version, extra), value)

    def clear(self) -> None:
        self._store.clear()
