"""``to_static`` (counterpart of ``paddle_tpu/jit/api.py:119
StaticFunction``).

The reference traces the wrapped step (forward, loss, backward and
``opt.step()``) into one XLA program per input signature. The port
captures it as one ``torch.cuda.CUDAGraph`` per signature and replays
it:

- **Cache.** ``_compiled`` maps ``(argument structure, (shape, dtype,
  device) of each tensor argument, the other arguments, registry
  version)`` to an entry, as the reference's ``self._compiled`` does; a
  state tensor registered since (a new optimizer, a lazily made
  accumulator: :mod:`paddle_tpu_torch.framework.state`) makes a new
  entry, and the entries of older versions, which no call can reach
  again, are released with their graphs' memory (the reference keeps
  them).
- **Device.** A step runs where its state does. With a CUDA tensor
  argument that is CUDA. Without one, on a machine with a card, one
  eager call of the step (undone after it) shows which registered state
  it changes: where that lies on CUDA, the step is captured there and
  its CPU arguments are staged into device buffers; else it runs on the
  CPU.
- **Discovery.** The first call of a CUDA signature snapshots every
  registered state tensor and each one's ``.grad``, runs the step
  eagerly ``cuda_graph.WARMUP_CALLS`` times on the capture stream (the
  kernel library, cuBLAS and the lazy accumulators are made; the last
  call records which parameters' gradients the step clears, by
  ``clear_grad``, ``zero_grad`` or assignment, before its backward adds
  to them), restores the snapshot (accumulators made meanwhile are
  filled with their inits), captures the step, and replays it once: the
  call takes one step. The snapshot lives on the device beside what it
  copies.
- **Calls.** Tensor arguments are copied into the entry's static
  buffers (CPU ones through pinned staging), the graph replays, the
  launch counts of the captured kernels are added, each parameter's
  ``.grad`` is pointed at the graph's gradient (a step that did not
  clear it adds its gradient to the one the parameter held before the
  call, as the reference's ``_apply`` does: the captured update sees
  the step's own gradient), and the outputs come back as copies the
  next call does not overwrite.
- **State.** Everything a step changes is a tensor it changes in place:
  weights, accumulators, the lr (``Optimizer.set_lr``, the LR
  schedulers and the sentinel's cooldown write it in place), the guard
  summary. A host value read inside the step (a Python float, a
  ``.item()``) is baked into the graph or refuses capture.
- **No fallback.** On CUDA a capture that fails raises with the step's
  name; nothing runs the step eagerly in its place. ``dygraph_function``
  is the raw function, for the loops that must run eagerly.
- **Fault hooks** (:mod:`paddle_tpu_torch.resilience.faultinject`) fire
  where the reference's fire, at its traces: while a signature is
  built, twice when its first call registers state (the reference's
  discovery trace, then the trace it compiles) and once otherwise, and
  never on a cached call. On CUDA the first warm-up is the discovery
  trace (its firings taken back when it registered nothing), the
  second warm-up fires nothing, and the capture is the compiled trace:
  a fault fired in the warm-up is undone by the restore, one fired in
  the capture is baked into every replay, as in the reference's
  program. ``dygraph_function`` fires once a call.

On the CPU the same cache keys an entry without a graph, and every call
runs the function eagerly: a signature's first call runs once, or, when
that call registered state, is undone and runs again (the reference's
two traces); a cached call runs with the hooks silenced.

Observability (:mod:`paddle_tpu_torch.observability`), as the
reference's: every call runs in a ``jit.<name>`` span; spans and counter
increments inside the step (``optimizer.step``, an injected fault's)
follow the fault hooks' rules above, through ``spans.quiet`` and
``spans.held``; and every cache miss is a ``jit`` event of the recompile
log (``note_jit_compile``), its cause found by diffing the new key
against the nearest key built before, named by the reference's leaf
names (``ids``, ``arg1['mask']``). The keys of every entry built stay
for that (not their graphs, which ``_keep`` releases). ``trace_ms`` is
the discovery and capture (on the CPU, the calls before the last),
``compile_ms`` the first replay's host time (on the CPU, the last eager
call).

``amp_policy="bf16"`` pushes the bf16 activation policy
(:mod:`paddle_tpu_torch.amp.policy`) around every call, warm-up and
capture. ``guard=True`` adds the training sentinel's loss probe: each
scalar float output's ``(value, isfinite)``, stacked on the device
inside the captured step and read on the host once after it, kept on
``last_guard`` (``values``, ``finite``, ``loss``, ``loss_finite``: the
first output's) and handed to the ambient
:class:`~paddle_tpu_torch.resilience.sentinel.TrainingSentinel`'s
``note_probe``. ``remat=True`` or ``"bf16"`` adds the remat mode to
that policy (with ``amp_policy=None``, a policy with remat alone): the
model's recompute units (GPT's decoder blocks) are recompute regions in
the step, ``"bf16"`` storing their saved f32 boundaries in bf16.
"""
from __future__ import annotations

import contextlib
import inspect
import time
import weakref

import torch

from paddle_tpu_torch.amp.policy import ActivationPolicy, activation_residency
from paddle_tpu_torch.core import cuda_graph
from paddle_tpu_torch.framework.state import (registry_version, state_init,
                                              state_tensors)
from paddle_tpu_torch.observability import note_jit_compile, span, spans
from paddle_tpu_torch.resilience import faultinject

__all__ = ["StaticFunction", "to_static"]

class _Leaf:
    __slots__ = ()

    def __repr__(self):
        return "<tensor-leaf>"


_TENSOR = _Leaf()


def _flatten(tree, leaves):
    """The structure of ``tree`` (tuples, lists, dicts), its leaves
    appended to ``leaves`` in order."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree),
                tuple(_flatten(v, leaves) for v in tree.values()))
    leaves.append(tree)
    return None


def _unflatten(struct, leaves):
    """The tree of ``struct`` over the iterator ``leaves``."""
    if struct is None:
        return next(leaves)
    if struct[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(struct[1],
                                                         struct[2])}
    kind, items = struct
    items = [_unflatten(s, leaves) for s in items]
    if kind in (tuple, list):
        return kind(items)
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _leaf_names(tree, base, names):
    """One name per leaf of ``tree`` in :func:`_flatten`'s order,
    ``base`` followed by the reference's path spelling (``[0]``,
    ``['mask']``, ``.field``)."""
    if isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", None)
        for i, t in enumerate(tree):
            _leaf_names(t, base + (f".{fields[i]}" if fields else f"[{i}]"),
                        names)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _leaf_names(v, f"{base}[{k!r}]", names)
    else:
        names.append(base)
    return names


@contextlib.contextmanager
def _silenced():
    """No fault hook, span or counter increment fires on this thread in
    the block."""
    with faultinject.quiet(), spans.quiet():
        yield


def _static_leaf(x):
    if isinstance(x, torch.Tensor):
        return _TENSOR
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"to_static: an argument of type "
                        f"{type(x).__name__} is neither a tensor nor "
                        f"hashable") from None
    return x


def _probe_stack(leaves):
    """``[n, 2]`` f32 ``(value, isfinite)`` of each scalar float tensor
    among ``leaves``, on the device (None when there is none)."""
    probes = [t.detach().reshape(()).float() for t in leaves
              if isinstance(t, torch.Tensor) and t.numel() == 1
              and t.is_floating_point()]
    if not probes:
        return None
    return torch.stack([torch.stack([v, torch.isfinite(v).float()])
                        for v in probes])


class _StateSnapshot:
    """Every registered state tensor's value and ``.grad`` (the global
    RNG key among them), and torch's random state (the CPU's, and
    ``device``'s when that is CUDA), copied beside what they copy;
    :meth:`restore` puts them back in place and fills a state tensor
    registered since with its init (a number, or a tensor such as the
    key's words)."""

    def __init__(self, device):
        self.device = device
        self.tensors = state_tensors()
        self.ids = {id(t) for t in self.tensors}
        with torch.no_grad():
            self.values = [t.detach().clone() for t in self.tensors]
            self.grads = [None if t.grad is None else t.grad.detach().clone()
                          for t in self.tensors]
        self.rng = torch.get_rng_state()
        self.cuda_rng = torch.cuda.get_rng_state(device) \
            if device.type == "cuda" else None

    def restore(self):
        with torch.no_grad():
            for t, v, g in zip(self.tensors, self.values, self.grads):
                t.copy_(v)
                if t.grad is not None or g is not None:
                    t.grad = g
            for t in state_tensors():
                if id(t) in self.ids:
                    continue
                init = state_init(t)
                if init is None:
                    raise RuntimeError(
                        "to_static: a state tensor without an init was "
                        "registered during the step's discovery calls")
                if isinstance(init, torch.Tensor):
                    t.copy_(init)
                else:
                    t.fill_(init)
                t.grad = None
        torch.set_rng_state(self.rng)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state(self.cuda_rng, self.device)


def _mark(t):
    """What tells that ``t`` changed: its version, its gradient (a weak
    reference: holding the tensor would keep a cleared gradient's memory
    alive) and that gradient's version."""
    g = t.grad
    if g is None:
        return t._version, None, None
    return t._version, weakref.ref(g), g._version


def _unchanged(mark, t):
    version, ref, grad_version = mark
    g = t.grad
    if t._version != version:
        return False
    if ref is None:
        return g is None
    return ref() is g and g._version == grad_version


def changed_state(call, device):
    """The registered state tensors that ``call()`` changes in place,
    whose gradient it sets or writes, or that it registers; the state,
    gradients and random state are put back after it."""
    snap = _StateSnapshot(device)
    marks = {id(t): _mark(t) for t in snap.tensors}
    with _silenced():
        call()
    changed = [t for t in state_tensors()
               if id(t) not in marks or not _unchanged(marks[id(t)], t)]
    snap.restore()
    return changed


@contextlib.contextmanager
def clears_watched(params):
    """Yields a set that, after the block, holds the ids of the
    parameters whose gradient the block cleared before its backward
    added to it: set to None or rebound (``clear_grad``, ``zero_grad``,
    an assignment) or written in place (``zero_grad(set_to_none=
    False)``). A parameter the block accumulated into is not in it."""
    start = {id(p): _mark(p) for p in params}
    seen, cleared = set(), set()

    def watch(p):
        def hook(_grad):
            if id(p) not in seen:           # the block's first backward
                seen.add(id(p))
                if p.grad is None or not _unchanged(start[id(p)], p):
                    cleared.add(id(p))
        return hook

    handles = [p.register_hook(watch(p)) for p in params]
    try:
        yield cleared
    finally:
        for h in handles:
            h.remove()


class _CompiledEntry:
    """One signature's captured step: the graph over its static input
    buffers, the structure and leaves of what the step returns, its
    guard probe, the gradient a replay leaves on each parameter, and
    the parameters whose gradient the step clears. ``graph`` is None on
    the CPU, where calls run eagerly."""

    def __init__(self, graph=None, out_struct=None, out_leaves=(),
                 probe=None, grads=(), cleared=frozenset()):
        self.graph = graph
        self.out_struct = out_struct
        self.out_leaves = [o.detach() if isinstance(o, torch.Tensor) else o
                           for o in out_leaves]
        self.probe = probe
        self.grads = grads
        self.cleared = cleared

    def __call__(self, tensors, loaded=False):
        """Replay with ``tensors`` in the buffers (already there when
        ``loaded``); (outputs, probe), the outputs copied out."""
        if not loaded:
            self.graph.inputs.load(tensors)
        before = [p.grad for p, _ in self.grads]
        self.graph.replay()
        with torch.no_grad():
            for (p, g), prior in zip(self.grads, before):
                if id(p) in self.cleared:
                    p.grad = g
                elif prior is None:
                    p.grad = g.clone()
                else:
                    prior.add_(g)
        out = _unflatten(self.out_struct, (
            o.clone() if isinstance(o, torch.Tensor) else o
            for o in self.out_leaves))
        return out, self.probe


class StaticFunction:
    """The callable :func:`to_static` returns."""

    def __init__(self, function, amp_policy=None, guard=False, remat=None):
        self._raw_function = function
        self._policy = None if amp_policy is None and not remat else \
            ActivationPolicy(amp_policy, remat=remat or False)
        self._guard = bool(guard)
        self.last_guard = None
        self._compiled = {}
        self._keys = []              # every entry's key, in build order
        self._stream = None
        self.__name__ = getattr(function, "__name__", "static_fn")
        self.__doc__ = getattr(function, "__doc__", None)
        self._span_name = f"jit.{self.__name__}"
        self._param_names = None     # resolved at the first build

    @property
    def dygraph_function(self):
        """The raw function: one eager step, uncaptured (as the
        reference's ``dygraph_function``)."""
        return self._raw_function

    def _eager(self, args, kwargs):
        with activation_residency(self._policy) \
                if self._policy is not None else contextlib.nullcontext():
            return self._raw_function(*args, **kwargs)

    def _eager_step(self, args, kwargs):
        """One eager call (the CPU path): (outputs, guard probe)."""
        out = self._eager(args, kwargs)
        if not self._guard:
            return out, None
        leaves = []
        _flatten(out, leaves)
        return out, _probe_stack(leaves)

    def __call__(self, *args, **kwargs):
        with span(self._span_name):
            return self._call(args, kwargs)

    def traced_program(self, *args, **kwargs):
        """One eager, uncaptured call of the step walked by the roofline
        profiler (:func:`paddle_tpu_torch.observability.profile.
        trace_call`; the reference traces its program instead): returns
        the call's :class:`~paddle_tpu_torch.observability.profile.
        CostTrace`. Every registered state tensor (weights, moments, the
        lr, the RNG key), its ``.grad`` and torch's random state are put
        back after it; no fault hook, span or counter fires in it."""
        from paddle_tpu_torch.observability import profile
        leaves = []
        _flatten((args, kwargs), leaves)
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor) and x.is_cuda), None)
        if device is None:
            device = next((t.device for t in state_tensors() if t.is_cuda),
                          torch.device("cpu"))
        snap = _StateSnapshot(device)
        try:
            with _silenced():
                return profile.trace_call(lambda: self._eager(args, kwargs))
        finally:
            snap.restore()

    def _call(self, args, kwargs):
        leaves = []
        struct = _flatten((args, kwargs), leaves)
        statics = tuple(_static_leaf(x) for x in leaves)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        sig = (struct, tuple((tuple(t.shape), t.dtype, t.device)
                             for t in tensors), statics)
        entry = self._compiled.get(sig + (registry_version(),))
        if entry is None:
            out, probe = self._build(sig, struct, leaves, tensors, args,
                                     kwargs)
        elif entry.graph is None:
            with _silenced():
                out, probe = self._eager_step(args, kwargs)
        else:
            out, probe = entry(tensors)
        if self._guard:
            self._note_guard(probe)
        return out

    def _device(self, tensors, args, kwargs):
        """Where the step runs: the device of a CUDA tensor argument;
        without one and with a card, that of the CUDA state one eager
        call (undone) changes; else the CPU."""
        for t in tensors:
            if t.is_cuda:
                return t.device
        if not torch.cuda.is_available():
            return torch.device("cpu")
        changed = changed_state(
            lambda: self._eager(args, kwargs),
            torch.device("cuda", torch.cuda.current_device()))
        return next((t.device for t in changed if t.is_cuda),
                    torch.device("cpu"))

    def _build(self, sig, struct, leaves, tensors, args, kwargs):
        """(CUDA) discovery, capture and one replay, or (CPU) one eager
        call; the entry is keyed after discovery, whose calls may
        register state. Either way one ``jit`` recompile event."""
        t0 = time.perf_counter()
        prior = list(self._keys)
        device = self._device(tensors, args, kwargs)
        if device.type != "cuda":
            snap = _StateSnapshot(device)
            version = registry_version()
            t_run = time.perf_counter()
            out = self._eager_step(args, kwargs)
            if registry_version() != version:
                # the reference's discovery trace registered state: it
                # traces again, and so the call runs again
                snap.restore()
                del snap
                t_run = time.perf_counter()
                out = self._eager_step(args, kwargs)
            done = time.perf_counter()
            event = self._note_build(self._keep(sig, _CompiledEntry()),
                                     prior, args, kwargs, t_run - t0)
            event.compile_ms = round((done - t_run) * 1e3, 3)
            return out
        entry = self._capture(struct, leaves, tensors, device)
        event = self._note_build(self._keep(sig, entry), prior, args,
                                 kwargs, time.perf_counter() - t0)
        t_run = time.perf_counter()
        out = entry(tensors, loaded=True)
        event.compile_ms = round((time.perf_counter() - t_run) * 1e3, 3)
        return out

    def _note_build(self, key, prior, args, kwargs, trace_s):
        """The recompile event of the entry ``key``: why it was built
        (against ``prior``, the keys built before), by leaf name."""
        if self._param_names is None:
            try:
                self._param_names = [
                    p.name for p in inspect.signature(
                        self._raw_function).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)]
            except (TypeError, ValueError):
                self._param_names = []
        names = []
        for i, a in enumerate(args):
            _leaf_names(a, self._param_names[i]
                        if i < len(self._param_names) else f"arg{i}", names)
        for k, v in kwargs.items():
            _leaf_names(v, str(k), names)
        return note_jit_compile(self.__name__, key, prior, names, _TENSOR,
                                trace_ms=round(trace_s * 1e3, 3))

    def _keep(self, sig, entry):
        """Key ``entry`` on the registry version after its discovery, and
        release the entries of older versions: the version only grows,
        so no call can reach them again. Returns the key."""
        version = registry_version()
        for key in [k for k in self._compiled if k[-1] != version]:
            stale = self._compiled.pop(key)
            if stale.graph is not None:
                stale.graph.release()
        key = sig + (version,)
        self._compiled[key] = entry
        self._keys.append(key)
        return key

    def _capture(self, struct, leaves, tensors, device):
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        inputs = cuda_graph.StaticInputs(tensors, device)

        def call(*buffers):
            it = iter(buffers)
            args, kwargs = _unflatten(struct, (
                next(it) if isinstance(x, torch.Tensor) else x
                for x in leaves))
            return self._eager(args, kwargs)

        snap = _StateSnapshot(device)
        params = [t for t in state_tensors() if t.requires_grad]
        version, fired = registry_version(), faultinject.mark()
        with spans.held() as kept:
            cuda_graph.warm_up(call, inputs.buffers, self._stream,
                               calls=cuda_graph.WARMUP_CALLS - 1)
        if registry_version() == version:
            # nothing registered: the reference traces once, and that
            # trace is the capture's (the spans kept back are dropped)
            faultinject.rewind(fired)
        else:
            kept.commit()
        with clears_watched(params) as cleared, _silenced():
            cuda_graph.warm_up(call, inputs.buffers, self._stream, calls=1)
        snap.restore()
        del snap
        # the buffers again: a step may write its inputs, and a copy
        # marks them changed for what memoises on them
        inputs.load(tensors)
        before = [p.grad for p in params]
        for p in params:
            p.grad = None
        captured = {}

        def region(*buffers):
            out_leaves = []
            captured["struct"] = _flatten(call(*buffers), out_leaves)
            captured["leaves"] = out_leaves
            captured["probe"] = _probe_stack(out_leaves) \
                if self._guard else None

        try:
            graph = cuda_graph.CapturedGraph(region, inputs, None,
                                             self._stream)
        except Exception as e:
            raise RuntimeError(f"to_static: capturing {self.__name__} "
                               f"failed: {e}") from e
        finally:
            grads = [(p, p.grad) for p in params if p.grad is not None]
            for p, g in zip(params, before):
                p.grad = g
        return _CompiledEntry(graph, captured["struct"], captured["leaves"],
                              captured["probe"], grads, frozenset(cleared))

    def _note_guard(self, probe):
        """``last_guard`` from the probe (one host read), handed to the
        ambient TrainingSentinel."""
        from paddle_tpu_torch.resilience import sentinel
        pairs = probe.tolist() if probe is not None else []
        values = [v for v, _ in pairs]
        finite = [f >= 0.5 for _, f in pairs]
        self.last_guard = {"values": values, "finite": finite,
                           "loss": values[0] if values else None,
                           "loss_finite": finite[0] if finite else True}
        ambient = sentinel.current()
        if ambient is not None:
            ambient.note_probe(self.__name__, self.last_guard)


def to_static(function=None, amp_policy=None, remat=None, guard=False):
    """Wrap a train step: a bare decorator, a decorator with options, or
    ``to_static(fn, ...)``; returns a :class:`StaticFunction`.
    ``amp_policy`` is None or "bf16"; ``remat`` None/False, True or
    "bf16" (recompute the model's blocks in the step, "bf16" saving
    their f32 boundaries in bf16); ``guard=True`` keeps the step's loss
    probe on ``fn.last_guard`` (None before the first call)."""
    ActivationPolicy(amp_policy, remat=remat or False)   # raises on bad ones

    def wrap(fn):
        return StaticFunction(fn, amp_policy=amp_policy, guard=guard,
                              remat=remat)

    return wrap(function) if function is not None else wrap
