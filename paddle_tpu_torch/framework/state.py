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

The global RNG key (counterpart of ``paddle_tpu/framework/state.py:
41-90``): ``seed`` maps to a threefry key, jax's ``key_data`` words
``(0, seed)`` held as a registered ``[2]`` int64 tensor, and every
random op draws with :func:`next_key`, which splits the key and writes
the advanced key back in place on the key's device (the keep-mask
kernel on CUDA, :mod:`paddle_tpu_torch.ops.cuda.random`), reading
nothing back to the host. So a step that ``to_static`` captured draws
fresh bits at every replay, and after every call the key holds the
reference's words. The key lives where it was last drawn on: a draw on
another device moves it there once (a new registered tensor, whose
init is the value it carried over, as the reference's ``_reinit``
gives the key its seed's value). Unlike the reference's, the key is
one for the process, not one per thread: autograd runs a recomputed
region's backward on its own thread, and that re-run must draw from
the same key.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

__all__ = ["get_rng_state", "key_tensor", "next_key", "register_state_tensor",
           "registry_version", "seed", "set_rng_state", "state_init",
           "state_tensors"]

_entries = {}           # id(tensor) -> (weakref, init), in registration order
_registry_version = [0]


def register_state_tensor(t, init=None):
    """Register ``t`` (``init``: the value it is made with, a number or
    a tensor of its shape, which a restore fills it with when it was made
    after the snapshot; None when it has no such value). Every
    registration bumps the version."""
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


# ------------------------------------------------------- the RNG key
class _RNG:
    def __init__(self):
        self.key = None          # the registered [2] int64 key words
        self.seed_val = 0


_rng = _RNG()


def _key_words(s):
    return torch.tensor([0, int(s) & 0xFFFFFFFF], dtype=torch.int64)


def _place_key(words, device):
    t = words.to(device=device, dtype=torch.int64, copy=True)
    register_state_tensor(t, init=t.clone())
    _rng.key = t
    return t


def key_tensor(device=None):
    """The global key's ``[2]`` int64 words, made from the seed at the
    first use (on ``device``, default the CPU) and moved to ``device``
    when it lies elsewhere."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    t = _rng.key
    if t is None:
        return _place_key(_key_words(_rng.seed_val),
                          torch.device("cpu") if device is None else device)
    if device is not None and t.device != device:
        return _place_key(t.detach(), device)
    return t


def seed(s):
    """``paddle.seed``: the global key becomes ``PRNGKey(s)``'s words,
    written in place where the key lives (a captured step then draws
    from it at its next replay). Returns the key tensor."""
    _rng.seed_val = int(s)
    t = _rng.key
    if t is None:
        return key_tensor()
    with torch.no_grad():
        t.copy_(_key_words(s))
    return t


def get_rng_state():
    """A copy of the global key's two words (int64 ``[2]`` on the key's
    device; ``jax.random.key_data``'s values)."""
    return key_tensor().detach().clone()


def set_rng_state(key_data):
    """Write two key words (a tensor or an array of uint32 values, as
    :func:`get_rng_state` or ``jax.random.key_data`` gives them) into the
    global key in place."""
    if not isinstance(key_data, torch.Tensor):
        key_data = torch.from_numpy(np.asarray(key_data).astype(np.int64))
    t = key_tensor()
    with torch.no_grad():
        t.copy_(key_data.reshape(2).to(torch.int64) & 0xFFFFFFFF)


def next_key(device=None):
    """Split the global key: the key advances in place to the split's
    first key and the second is returned (``[2]`` int64 words on the
    key's device, moved to ``device`` first when given)."""
    from paddle_tpu_torch.ops.cuda.random import keep_mask
    with torch.no_grad():
        return keep_mask(key_tensor(device), 1.0, (0,))[1]
