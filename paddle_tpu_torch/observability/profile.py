"""Whole-program roofline profiler with per-layer cost attribution
(counterpart of ``paddle_tpu/observability/profile.py``).

The reference walks a traced jaxpr. The port has no jaxpr: it walks one
eager, uncaptured call of the program instead, and books every operation
that call runs, deterministically, for any program built from the port's
modules (``StaticFunction.traced_program()``,
``LLMEngine.audit_programs()``):

- **scope threading**: while a walk runs (or :func:`module_scopes` is
  open), every ``torch.nn.Module`` call opens a :class:`layer_scope`
  named from the module tree, as the reference's ``nn.Layer.__call__``
  does (the attribute name under the parent, so two Linears never
  collide; ``classname_i`` for a container's index; the class name for
  a root), through process-wide forward hooks that are removed again
  after; user code and ``optimizer.step`` open scopes the same way. While
  a ``torch.profiler`` runs, a scope also opens
  ``torch.profiler.record_function(path)``, so measured kernel time can
  be grouped by the same paths;
- **backward attribution**: each forward operation's autograd node
  records the scope it was made in (``node.metadata``), and the walk
  books an operation that runs in the backward under the scope of the
  node running it (``torch._C._current_autograd_node()``), as the
  reference's name stack carries a layer's scope into its transposed
  eqns. An :func:`op_scope` (the scope ``jnp.einsum`` opens around its
  contraction in the reference) books its backward under its own name
  alone, as the reference's freshly traced backwards do
  (:func:`normalize_scope`'s marker rule);
- **deterministic per-op cost model** (:func:`op_cost`): every aten
  operation gets analytic flops (``2·M·N·K`` for ``mm``/``bmm``/
  ``addmm``, kernel-volume MACs for a convolution, element counts for
  pointwise operations and for a reduction's input) and bytes (operands
  + results; a view moves none);
- **kernels at their call boundary**: a port kernel (``ops/cuda``) is
  booked by its wrapper as one row, its operands plus results in bytes
  and its analytic operations, from :mod:`paddle_tpu_torch.ops.cuda.cost`
  (the formula of the kernel table's bounds), whether it launches or
  computes its plain version; the plain version's own operations are
  not booked. :func:`kernel_interiors` reads each launch's grid and the
  bytes its blocks stage;
- **attribution and roofline**: costs aggregate per scope path, the rest
  in an explicit ``<unattributed>`` bucket; each layer's arithmetic
  intensity is classified against a :class:`ChipSpec`, and its floor is
  the sum over its operations of the larger of their bytes' and their
  operations' time on that chip.

The walk never runs inside a CUDA-graph capture and works the same on
the CPU and on the card. ``torch.utils.flop_counter.FlopCounterMode``
counts the same call's flops independently (:func:`flop_counter_totals`),
as the reference's XLA ``cost_analysis()`` cross-checks its model.
"""
from __future__ import annotations

import contextlib
import re
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.ops.cuda import cost as _cost
from paddle_tpu_torch.ops.cuda import launch as _launch

__all__ = [
    "BWD_MARKER", "CHIP_SPECS", "ChipSpec", "CostTrace", "LayerCost",
    "RooflineReport", "UNATTRIBUTED", "current_scope", "default_chip",
    "flop_counter_totals", "kernel_interiors", "layer_scope",
    "module_scopes", "normalize_scope", "op_cost", "op_scope",
    "profile_engine", "profile_static_function", "profile_traced",
    "reconcile", "scope", "scope_name", "scope_tagging",
    "set_scope_tagging", "trace_call",
]


# ------------------------------------------------------- scope threading
_TAGGING = [True]               # list, not bool: mutation without `global`
_tls = threading.local()        # .stack [(path, backward path)], .mods
BWD_MARKER = "~bwd~"
_NODE_KEY = "paddle_tpu_torch.scope"   # an autograd node's backward scope


def set_scope_tagging(flag=True):
    """Globally enable/disable layer-scope tagging; returns the previous
    value. Off, :class:`layer_scope` pushes nothing."""
    prev = _TAGGING[0]
    _TAGGING[0] = bool(flag)
    return prev


def scope_tagging():
    return _TAGGING[0]


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_scope():
    """The full scope path active on this thread (``'model/fc1'``)."""
    st = getattr(_tls, "stack", None)
    return st[-1][0] if st else ""


def _backward_scope():
    """Where the backward of an operation made now is booked: the current
    path, or, inside an :func:`op_scope`, the path from that scope on."""
    st = getattr(_tls, "stack", None)
    if not st:
        return ""
    path, bwd = st[-1]
    return path if bwd is None else bwd


class layer_scope:
    """The one scope primitive instrumented code uses::

        with profile.scope("loss"):
            loss = F.cross_entropy(logits, labels)

    pushes ``parent/loss`` on this thread's scope stack (and, under a
    torch profiler, opens ``record_function`` of the path). Tagging off
    (or an empty name) makes it a no-op."""

    __slots__ = ("name", "_op", "_pushed", "_rf")

    def __init__(self, name, _op=False):
        self.name = name
        self._op = _op

    def __enter__(self):
        self._rf = None
        self._pushed = False
        if not _TAGGING[0] or not self.name:
            return self
        st = _stack()
        parent, pbwd = st[-1] if st else ("", None)
        path = f"{parent}/{self.name}" if parent else self.name
        if pbwd is not None:
            bwd = f"{pbwd}/{self.name}"
        else:
            bwd = self.name if self._op else None
        st.append((path, bwd))
        self._pushed = True
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(path)
            self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        if self._pushed:
            _tls.stack.pop()
        return False


scope = layer_scope


def op_scope(name):
    """The scope an operation opens around its own work (the reference's
    ``jnp.einsum`` names its contraction ``"bqhd,bkhd->bhqk"``): forward
    work books under ``parent/name``, its backward under ``name``."""
    return layer_scope(name, _op=True)


# jvp(model) / transpose(jvp(model)) / vmap(f) ... — the reference's
# transform wrappers around scope components
_WRAP_RE = re.compile(r"[A-Za-z_][\w.]*\(")


def normalize_scope(stack_str):
    """``'transpose(jvp(model))/fc1'`` -> ``'model/fc1'``, the reference's
    rule for its name stacks: drop the transform wrappers, keep the scope
    path; a backward marker yields to any real components after it, else
    decodes to its recorded forward path. The port's own paths are clean
    already and come back as they are."""
    if not stack_str:
        return ""
    s = _WRAP_RE.sub("", stack_str).replace(")", "")
    parts = [p for p in s.split("/") if p]
    for i in range(len(parts) - 1, -1, -1):
        if parts[i].startswith(BWD_MARKER):
            rest = parts[i + 1:]
            parts = rest if rest else parts[i][len(BWD_MARKER):].split("|")
            break
    return "/".join(parts)


def scope_name(module, parent=None):
    """``module``'s component on the scope path: its attribute name under
    ``parent`` (the module whose forward calls it; unique among
    siblings), ``classname_i`` for a container index, and its class name
    when it has no parent or is not one of the parent's modules. The
    first name a module gets stays its name."""
    cached = module.__dict__.get("_scope_name")
    if cached is not None:
        return cached
    local = None
    if parent is not None:
        for path, m in parent.named_modules():
            if m is module and path:
                local = path.rsplit(".", 1)[-1]
                break
    cls = type(module).__name__.lower()
    if local is None:
        name = cls
    elif local.isdigit():
        name = f"{cls}_{local}"
    else:
        name = local
    module.__dict__["_scope_name"] = name
    return name


def _module_pre_hook(module, args):
    mods = getattr(_tls, "mods", None)
    if mods is None:
        mods = _tls.mods = []
    sc = None
    if _TAGGING[0]:
        sc = layer_scope(scope_name(module, mods[-1][0] if mods else None))
        sc.__enter__()
    mods.append((module, sc))


def _module_post_hook(module, args, output):
    mods = getattr(_tls, "mods", None)
    if mods and mods[-1][0] is module:
        _, sc = mods.pop()
        if sc is not None:
            sc.__exit__(None, None, None)


_HOOKS = []                     # the two hooks' handles while installed
_HOOK_USERS = [0]
_HOOK_LOCK = threading.Lock()


@contextlib.contextmanager
def module_scopes():
    """While open, every ``nn.Module`` call opens its scope, as every
    ``nn.Layer.__call__`` does in the reference: two process-wide forward
    hooks, installed by the first user and removed by the last.
    :func:`trace_call` opens it; open it around a ``torch.profiler`` run
    to group kernel time by module paths. Outside it a module call runs
    none of the profiler's hooks."""
    mod = torch.nn.modules.module
    with _HOOK_LOCK:
        if not _HOOK_USERS[0]:
            _HOOKS[:] = [
                mod.register_module_forward_pre_hook(_module_pre_hook),
                mod.register_module_forward_hook(_module_post_hook,
                                                 always_call=True)]
        _HOOK_USERS[0] += 1
    try:
        yield
    finally:
        with _HOOK_LOCK:
            _HOOK_USERS[0] -= 1
            if not _HOOK_USERS[0]:
                for h in _HOOKS:
                    h.remove()
                _HOOKS.clear()


# ------------------------------------------------------------ chip specs
@dataclass(frozen=True)
class ChipSpec:
    """Roofline parameters of one card: bf16 tensor-core peak, HBM rate,
    and the f32 and int32 rates the kernel table's bounds use (by default
    those of :data:`paddle_tpu_torch.ops.cuda.cost.PEAKS`)."""

    name: str
    peak_tflops: float          # bf16 dense tensor-core peak, TFLOP/s
    hbm_gbs: float              # HBM bandwidth, GB/s
    f32_tflops: float = _cost.PEAKS["f32"] / 1e12    # non-tensor-core f32
    int32_tops: float = _cost.PEAKS["int32"] / 1e12
    smem_kb: float = 228.0      # shared memory an SM

    @property
    def peak_flops(self):
        return self.peak_tflops * 1e12

    @property
    def bw_bytes(self):
        return self.hbm_gbs * 1e9

    @property
    def ridge(self):
        """Arithmetic intensity (flop/byte) where compute == memory."""
        return self.peak_flops / self.bw_bytes

    def peaks(self):
        """{kind: operations a second}, the kinds of
        :data:`paddle_tpu_torch.ops.cuda.cost.PEAKS`."""
        return {"bf16": self.peak_flops, "f32": self.f32_tflops * 1e12,
                "int32": self.int32_tops * 1e12}

    def to_dict(self):
        return {"name": self.name, "peak_tflops": self.peak_tflops,
                "hbm_gbs": self.hbm_gbs,
                "ridge_flop_per_byte": round(self.ridge, 1),
                "f32_tflops": self.f32_tflops,
                "int32_tops": round(self.int32_tops, 3),
                "smem_kb": self.smem_kb}


# NVIDIA's published H100 SXM rates (the kernel table's)
CHIP_SPECS = {
    "h100": ChipSpec("NVIDIA H100 SXM", _cost.PEAKS["bf16"] / 1e12,
                     _cost.HBM_BYTES_PER_S / 1e9),
}


def default_chip():
    """The spec of the card the port runs on (``torch.cuda.
    get_device_name``) when it is a known one, else H100's: a CPU host
    profiles for the card."""
    name = ""
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
    key = name.lower().replace(" ", "")
    for k, spec in CHIP_SPECS.items():
        if k in key:
            return spec
    return CHIP_SPECS["h100"]


# ----------------------------------------------------- per-op cost model
# pointwise ops: one flop per output element
_ELEMENTWISE = frozenset((
    "abs", "add", "atan2", "bitwise_and", "bitwise_not", "bitwise_or",
    "bitwise_xor", "ceil", "clamp", "clamp_max", "clamp_min", "copysign",
    "cos", "cosh", "div", "elu", "eq", "erf", "erfc", "erfinv", "exp",
    "exp2", "expm1", "floor", "fmax", "fmin", "fmod", "ge", "gt",
    "hardtanh", "isinf", "isnan", "le", "leaky_relu", "log", "log10",
    "log1p", "log2", "logical_and", "logical_not", "logical_or",
    "logical_xor", "lt", "masked_fill", "maximum", "minimum", "mul",
    "nan_to_num", "ne", "neg", "pow", "reciprocal", "relu", "remainder",
    "round", "rsqrt", "rsub", "sigmoid", "sign", "signbit", "sin", "sinh",
    "sqrt", "square", "sub", "tan", "tanh", "threshold_backward", "trunc",
    "where", "xlogy",
))
# fused pointwise ops: flops per output element
_PER_ELEMENT = {
    "addcdiv": 2, "addcmul": 2, "lerp": 2, "tanh_backward": 2,
    "sigmoid_backward": 2, "gelu": 8, "gelu_backward": 12, "silu": 4,
    "silu_backward": 6, "_softmax": 5, "_log_softmax": 5,
    "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
    "native_layer_norm": 8, "native_layer_norm_backward": 20,
}
# reductions and scans: one flop per INPUT element
_REDUCTION = frozenset((
    "all", "amax", "amin", "any", "argmax", "argmin", "cummax", "cummin",
    "cumprod", "cumsum", "linalg_vector_norm", "logsumexp", "max", "mean",
    "min", "norm", "prod", "std", "std_mean", "sum", "var", "var_mean",
))
# allocations and metadata: no bytes moved
_FREE = frozenset((
    "_unsafe_view", "alias", "detach", "empty", "empty_like",
    "empty_strided", "lift_fresh", "new_empty", "new_empty_strided",
    "resize_", "set_",
))
_NARROW = (torch.bfloat16, torch.float16)


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _tbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def op_cost(func, args, kwargs, out):
    """Deterministic ``(flops, bytes, matmul_flops, peak kind)`` of one
    aten operation (the counterpart of the reference's ``eqn_cost``):
    every tensor operand read and every result written, a view or an
    allocation none; matmul flops from the contraction volume,
    pointwise and reduction flops from element counts, anything else
    zero flops but its bytes."""
    name = func._overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name
    if func.is_view or name in _FREE or base in _FREE:
        return 0, 0, 0, "f32"
    ins = _tensors(args, [])
    _tensors(kwargs, ins)
    outs = _tensors(out, [])
    nbytes = _tbytes(ins) + _tbytes(outs)
    first = outs[0].numel() if outs else 0
    if base in ("mm", "bmm", "addmm", "baddbmm", "mv", "addmv"):
        a = args[1] if base in ("addmm", "baddbmm", "addmv") else args[0]
        mm = 2 * first * a.shape[-1]
        kind = "bf16" if a.dtype in _NARROW else "f32"
        extra = first if base.startswith("add") or base == "baddbmm" else 0
        return mm + extra, nbytes, mm, kind
    if base in ("dot", "vdot"):
        mm = 2 * args[0].numel()
        return mm, nbytes, mm, "bf16" if args[0].dtype in _NARROW else "f32"
    if base == "convolution":
        w = args[1]
        mm = 2 * first * max(1, w.numel() // max(1, w.shape[0]))
        return mm, nbytes, mm, "bf16" if w.dtype in _NARROW else "f32"
    if base.startswith("_scaled_dot_product") and not base.endswith(
            "backward"):
        q, k = args[0], args[1]
        mm = 4 * q.numel() // q.shape[-1] * k.shape[-2] * q.shape[-1]
        return mm, nbytes, mm, "bf16" if q.dtype in _NARROW else "f32"
    if base in _ELEMENTWISE:
        return first, nbytes, 0, "f32"
    if base in _PER_ELEMENT:
        return _PER_ELEMENT[base] * first, nbytes, 0, "f32"
    if base in _REDUCTION:
        return (args[0].numel() if args and isinstance(args[0], torch.Tensor)
                else 0), nbytes, 0, "f32"
    if base in ("nll_loss_forward", "nll_loss2d_forward"):
        return args[1].numel(), nbytes, 0, "f32"
    return 0, nbytes, 0, "f32"


# ------------------------------------------------------------- the walk
@dataclass
class CostTrace:
    """What one walked call ran: ``ops`` ``(scope, flops, bytes,
    matmul_flops, peak kind)`` per booked operation, ``kernels`` ``(scope,
    KernelCost)`` per booked launch, and the independent flop count of
    ``FlopCounterMode`` over the same call."""

    ops: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    flop_counter: int = 0


class _Walk(TorchDispatchMode):
    """Books every aten operation of the call it is active over.

    Forward operations book under :func:`current_scope`, and each result
    remembers where its backward books; the next operation (by then
    autograd has made the result's node) writes that into the node's
    metadata. An operation the autograd engine runs books under its
    running node's scope. A kernel wrapper (:func:`paddle_tpu_torch.ops.
    cuda.launch.booked`) books its launches and silences the operations
    inside it."""

    _CAP = 4096          # results awaiting a node, kept across no-grad work

    def __init__(self):
        super().__init__()
        self.trace = CostTrace()
        self._quiet = 0
        self._pending = []

    def _resolve(self, drop_unset):
        keep = []
        for ref, where in self._pending:
            t = ref()
            if t is None:
                continue
            fn = t.grad_fn
            if fn is not None:
                fn.metadata.setdefault(_NODE_KEY, where)
            elif not drop_unset:
                keep.append((ref, where))
        self._pending = keep[-self._CAP:]

    def _scope(self):
        node = torch._C._current_autograd_node()
        self._resolve(drop_unset=node is None and torch.is_grad_enabled())
        if node is None:
            return current_scope(), True
        return node.metadata.get(_NODE_KEY, ""), False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        path, forward = self._scope()
        if forward:
            where = _backward_scope()
            for t in _tensors(out, []):
                if t.is_floating_point() or t.is_complex():
                    self._pending.append((weakref.ref(t), where))
        if not self._quiet:
            flops, nbytes, mm, kind = op_cost(func, args, kwargs, out)
            if flops or nbytes:
                self.trace.ops.append((path, flops, nbytes, mm, kind))
        return out

    @staticmethod
    def op_scope(name):
        return op_scope(name)

    @contextlib.contextmanager
    def kernel(self, costs):
        if self._quiet:
            yield
            return
        path, _ = self._scope()
        for c in costs:
            self.trace.kernels.append((path, c))
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1


def trace_call(call):
    """Walk one call of ``call()``: returns its :class:`CostTrace`. The
    call runs eagerly, uncaptured; it must not nest another walk."""
    from torch.utils.flop_counter import FlopCounterMode
    if _launch.WALK[0] is not None:
        raise RuntimeError("a profiler walk is already running")
    walk = _Walk()
    counter = FlopCounterMode(display=False)
    _launch.WALK[0] = walk
    try:
        with module_scopes(), counter, walk:
            call()
    finally:
        _launch.WALK[0] = None
    walk.trace.flop_counter = int(counter.get_total_flops())
    return walk.trace


# --------------------------------------------------------------- reports
UNATTRIBUTED = "<unattributed>"


@dataclass
class LayerCost:
    """Aggregated cost of one scope path (one layer, usually):
    ``matmul_flops`` the products' share of ``flops``, ``floor_ms`` the
    sum of its operations' roofline times on the report's chip."""

    name: str
    flops: int = 0
    bytes: int = 0
    n_eqns: int = 0
    matmul_flops: int = 0
    floor_ms: float = 0.0

    @property
    def intensity(self):
        """Arithmetic intensity, flop/byte."""
        return self.flops / self.bytes if self.bytes else 0.0

    def bound(self, chip):
        return "compute" if self.intensity >= chip.ridge else "memory"

    def to_dict(self, chip=None):
        d = {"name": self.name, "flops": self.flops, "bytes": self.bytes,
             "n_eqns": self.n_eqns, "intensity": round(self.intensity, 3),
             "matmul_flops": self.matmul_flops,
             "floor_ms": self.floor_ms}
        if chip is not None:
            d["bound"] = self.bound(chip)
        return d


@dataclass
class RooflineReport:
    """Per-layer bytes/flops attribution + roofline classification of
    one walked program (the reference's keys; ``kernels`` the booked
    launches)."""

    where: str
    chip: ChipSpec
    layers: list = field(default_factory=list)   # LayerCost, bytes desc
    unattributed: LayerCost = None
    xla: dict = None
    measured_ms: float = None
    measured_source: str = None
    interiors: list = None
    kernels: list = None

    def __post_init__(self):
        if self.unattributed is None:
            self.unattributed = LayerCost(UNATTRIBUTED)

    @property
    def attributed_flops(self):
        return sum(l.flops for l in self.layers)

    @property
    def attributed_bytes(self):
        return sum(l.bytes for l in self.layers)

    @property
    def total_flops(self):
        return self.attributed_flops + self.unattributed.flops

    @property
    def total_bytes(self):
        return self.attributed_bytes + self.unattributed.bytes

    @property
    def frac_attributed_flops(self):
        return self.attributed_flops / self.total_flops \
            if self.total_flops else 1.0

    @property
    def frac_attributed_bytes(self):
        return self.attributed_bytes / self.total_bytes \
            if self.total_bytes else 1.0

    @property
    def bound_fraction(self):
        """Fraction of attributed bytes in memory-bound layers."""
        if not self.attributed_bytes:
            return 0.0
        mem = sum(l.bytes for l in self.layers
                  if l.bound(self.chip) == "memory")
        return mem / self.attributed_bytes

    @property
    def top_layer(self):
        return self.layers[0].name if self.layers else ""

    @property
    def predicted_ms(self):
        """The reference's whole-program floor on `chip`:
        ``max(flops/peak, bytes/bw)``."""
        return max(self.total_flops / self.chip.peak_flops,
                   self.total_bytes / self.chip.bw_bytes) * 1e3

    @property
    def floor_ms(self):
        """Sum of every operation's own roofline time (each at the peak
        of its kind): the floor of a program that runs its operations one
        after another."""
        return sum(l.floor_ms for l in self.layers) \
            + self.unattributed.floor_ms

    def rows(self):
        """Every bucket including ``<unattributed>``, bytes-descending."""
        out = list(self.layers)
        if self.unattributed.n_eqns:
            out.append(self.unattributed)
        return sorted(out, key=lambda l: (-l.bytes, l.name))

    def to_dict(self):
        d = {
            "where": self.where,
            "chip": self.chip.to_dict(),
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "attributed_flops_pct": round(
                100.0 * self.frac_attributed_flops, 2),
            "attributed_bytes_pct": round(
                100.0 * self.frac_attributed_bytes, 2),
            "bound_fraction": round(self.bound_fraction, 4),
            "predicted_ms": round(self.predicted_ms, 6),
            "floor_ms": round(self.floor_ms, 6),
            "top_layer": self.top_layer,
            "layers": [l.to_dict(self.chip) for l in self.rows()],
        }
        if self.xla is not None:
            d["xla"] = self.xla
        if self.measured_ms is not None:
            d["measured_ms"] = round(self.measured_ms, 3)
            d["measured_source"] = self.measured_source
        if self.interiors:
            d["interiors"] = self.interiors
        if self.kernels:
            d["kernels"] = self.kernels
        return d

    @classmethod
    def from_dict(cls, d):
        c = d["chip"]
        chip = ChipSpec(c["name"], c["peak_tflops"], c["hbm_gbs"],
                        **{k: c[k] for k in ("f32_tflops", "int32_tops",
                                             "smem_kb") if k in c})
        layers, unattributed = [], None
        for row in d.get("layers", ()):
            lc = LayerCost(row["name"], int(row["flops"]), int(row["bytes"]),
                           int(row.get("n_eqns", 0)),
                           int(row.get("matmul_flops", 0)),
                           float(row.get("floor_ms", 0.0)))
            if lc.name == UNATTRIBUTED:
                unattributed = lc
            else:
                layers.append(lc)
        return cls(where=d.get("where", "<dump>"), chip=chip,
                   layers=sorted(layers, key=lambda l: (-l.bytes, l.name)),
                   unattributed=unattributed, xla=d.get("xla"),
                   measured_ms=d.get("measured_ms"),
                   measured_source=d.get("measured_source"),
                   interiors=d.get("interiors"), kernels=d.get("kernels"))


def _kernel_row(path, c, chip):
    bound, by = _cost.bound_ms(c.bytes, c.flops, c.peak, chip.bw_bytes,
                               chip.peaks())
    return {"kernel": c.name, "scope": path or UNATTRIBUTED,
            "shape": list(c.shape), "bytes": int(c.bytes),
            "flops": int(c.flops), "peak": c.peak,
            "bound_ms": bound, "bound_by": by}


def profile_traced(trace, where="<walked program>", chip=None,
                   include_xla=False, include_interiors=False):
    """Roofline report of one :class:`CostTrace`: its operations and
    launches aggregated per scope path, each one's floor at its kind's
    peak on `chip`."""
    chip = chip or default_chip()
    peaks = chip.peaks()
    sink = {}

    def book(path, flops, nbytes, mm, floor_s):
        agg = sink.setdefault(path, [0, 0, 0, 0, 0.0])
        agg[0] += flops
        agg[1] += nbytes
        agg[2] += 1
        agg[3] += mm
        agg[4] += floor_s

    for path, flops, nbytes, mm, kind in trace.ops:
        book(path, flops, nbytes, mm,
             max(nbytes / chip.bw_bytes, flops / peaks[kind]))
    kernels = []
    for path, c in trace.kernels:
        row = _kernel_row(path, c, chip)
        kernels.append(row)
        book(path, c.flops, c.bytes, c.flops if c.name.startswith(
            ("flash", "bsa")) else 0, row["bound_ms"] / 1e3)
    layers, unattributed = [], LayerCost(UNATTRIBUTED)
    for path, (flops, nbytes, n, mm, floor_s) in sink.items():
        lc = LayerCost(path or UNATTRIBUTED, flops, nbytes, n, mm,
                       floor_s * 1e3)
        if path:
            layers.append(lc)
        else:
            unattributed = lc
    layers.sort(key=lambda l: (-l.bytes, l.name))
    rep = RooflineReport(where=where, chip=chip, layers=layers,
                         unattributed=unattributed, kernels=kernels or None)
    if include_xla:
        rep.xla = flop_counter_totals(trace)
    if include_interiors:
        rep.interiors = kernel_interiors(trace, chip=chip)
    return rep


def flop_counter_totals(trace):
    """The independent flop count of the walked call
    (``torch.utils.flop_counter.FlopCounterMode``: matmuls, convolutions
    and attention only), in the reference's ``xla`` slot; it counts no
    bytes."""
    return {"flops": float(trace.flop_counter), "bytes_accessed": None,
            "source": "torch.utils.flop_counter"}


def kernel_interiors(trace, chip=None):
    """Per-launch INTERIOR rows, the dual of the call-boundary row: the
    launch's grid, the bytes a block stages at once, the bytes all its
    blocks stage (the tiles a flash block re-reads for every step count
    again), and ``reuse_factor`` = interior / boundary bytes, the reuse
    that justifies the kernel (near 1.0: one pass over its bytes)."""
    chip = chip or default_chip()
    rows = []
    for path, c in trace.kernels:
        intensity = c.flops / c.interior_bytes if c.interior_bytes else 0.0
        rows.append({
            "kernel": c.name,
            "scope": path or UNATTRIBUTED,
            "grid_steps": int(c.grid),
            "smem_step_bytes": int(c.stage_bytes),
            "interior_bytes": int(c.interior_bytes),
            "boundary_bytes": int(c.bytes),
            "flops": int(c.flops),
            "interior_intensity": round(intensity, 3),
            "bound": "compute" if intensity >= chip.ridge else "memory",
            "reuse_factor": round(c.interior_bytes / c.bytes, 2)
            if c.bytes else 0.0,
            "smem_fits": c.stage_bytes <= chip.smem_kb * 1024,
        })
    return rows


# ---------------------------------------------------------- entry points
def profile_static_function(fn, *args, where=None, chip=None,
                            include_xla=False, **kwargs):
    """Profile one ``to_static`` step: one eager call of it, its state
    restored after (:meth:`StaticFunction.traced_program`), attributed to
    the model's layers."""
    trace = fn.traced_program(*args, **kwargs)
    return profile_traced(
        trace, where=where or f"<{getattr(fn, '__name__', 'static_fn')}>",
        chip=chip, include_xla=include_xla)


def profile_engine(engine, chip=None, include_xla=False):
    """{program_name: RooflineReport} over every program the serving
    engine builds (``LLMEngine.audit_programs()``), each walked once
    uncaptured on copies of the engine's pools."""
    out = {}
    for name, (fn, example) in engine.audit_programs().items():
        with torch.no_grad():
            trace = trace_call(lambda: fn(*example))
        out[name] = profile_traced(trace, where=f"<serving {name}>",
                                   chip=chip, include_xla=include_xla)
    return out


def reconcile(report, span_name, recorder=None):
    """Fill ``measured_ms`` from the span layer's per-name aggregates
    (``serving.decode``, ``jit.train_step``), so predicted and measured
    sit in one report."""
    from paddle_tpu_torch.observability import spans as _spans
    rec = recorder or _spans.recorder()
    agg = rec.aggregates().get(span_name)
    if agg and agg.get("count"):
        report.measured_ms = agg["total_ms"] / agg["count"]
        report.measured_source = f"span {span_name} (n={agg['count']})"
    return report
