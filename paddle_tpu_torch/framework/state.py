"""The state-tensor registry (counterpart of
``paddle_tpu/framework/state.py:26-39``).

Every tensor a train step may change in place registers here: an
optimizer's parameters, its accumulators (each with the value it is made
with, its ``init``), its learning-rate tensor and its guard summary.
:class:`paddle_tpu_torch.jit.api.StaticFunction` snapshots them around
its discovery calls and keys its cache on :func:`registry_version`, so a
tensor registered later (a new optimizer, a lazily made accumulator)
makes the next call of a step build a new entry. The registry holds
weak references: a dropped model does not stay alive through it.
"""
from __future__ import annotations

import weakref

__all__ = ["register_state_tensor", "registry_version", "state_init",
           "state_tensors"]

_entries = {}           # id(tensor) -> (weakref, init), in registration order
_registry_version = [0]


def register_state_tensor(t, init=None):
    """Register ``t`` (``init``: the value it is made with, which a
    restore fills it with when it was made after the snapshot; None when
    it has no such value). Every registration bumps the version."""
    _registry_version[0] += 1
    key = id(t)
    entry = _entries.get(key)
    if entry is not None and entry[0]() is t:
        if init is not None:
            _entries[key] = (entry[0], init)
        return

    def drop(ref, key=key):
        if _entries.get(key, (None,))[0] is ref:
            del _entries[key]

    _entries[key] = (weakref.ref(t, drop), init)


def state_tensors():
    """The live registered tensors."""
    live = (ref() for ref, _ in list(_entries.values()))
    return [t for t in live if t is not None]


def state_init(t):
    """The ``init`` ``t`` registered with (None when it has none or did
    not register)."""
    entry = _entries.get(id(t))
    return entry[1] if entry is not None and entry[0]() is t else None


def registry_version():
    """Bumped by every registration."""
    return _registry_version[0]
