"""Workload models: a JSON-able :class:`TrafficSpec` compiled into a
deterministic request trace (counterpart of
``paddle_tpu/serving/traffic/workload.py``; the same spec compiles to a
byte-identical trace in both packages).

The spec is data (``to_dict`` / ``from_dict`` round-trip exactly), and
compilation is a pure function of ``(spec, spec.seed)``: the same spec
always yields a byte-identical trace (:func:`trace_digest` is the proof
handle). Nothing here reads the wall clock or global random state: one
``random.Random(seed)`` drives every draw in a fixed order.

A spec describes, independently:

- the **arrival process**: ``{"kind": "poisson", "rate_qps": R}`` or an
  on/off burst model ``{"kind": "onoff", "base_qps": B,
  "burst_qps": S, "period_s": P, "duty": D}`` (the first ``D`` fraction
  of every period runs at ``burst_qps``);
- the **prompt / output length mixtures**: weighted uniform ranges
  ``[[weight, lo, hi], ...]`` (inclusive bounds, token counts);
- the **shared-prefix ratio**: a fraction of requests opens with one
  spec-wide common prefix;
- the **deadline classes**: named SLO tiers (:class:`DeadlineClass`)
  with a TTFT SLO, an optional enforced engine deadline, and a mixture
  weight;
- an optional **fault plan** (``spec.fault_plan``, a FaultPlan dict):
  the driver arms it for the run.
"""
from __future__ import annotations

import hashlib
import json
import random

__all__ = ["DeadlineClass", "TraceRequest", "TrafficSpec",
           "compile_trace", "trace_digest"]


class DeadlineClass:
    """One SLO tier: requests of this class declare a TTFT SLO (the
    goodput bar the driver accounts against) and optionally an ENFORCED
    engine deadline (``SamplingParams.deadline_s`` — the engine expires
    the request past it).  ``weight`` is the mixture weight."""

    def __init__(self, name, ttft_slo_s, deadline_s=None, weight=1.0):
        if ttft_slo_s <= 0:
            raise ValueError("ttft_slo_s must be positive")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        if weight <= 0:
            raise ValueError("weight must be positive")
        self.name = str(name)
        self.ttft_slo_s = float(ttft_slo_s)
        self.deadline_s = float(deadline_s) if deadline_s is not None \
            else None
        self.weight = float(weight)

    def to_dict(self):
        return {"name": self.name, "ttft_slo_s": self.ttft_slo_s,
                "deadline_s": self.deadline_s, "weight": self.weight}

    @classmethod
    def from_dict(cls, d):
        return cls(d["name"], d["ttft_slo_s"], d.get("deadline_s"),
                   d.get("weight", 1.0))

    def __repr__(self):
        return (f"DeadlineClass({self.name!r}, "
                f"ttft_slo_s={self.ttft_slo_s}, "
                f"deadline_s={self.deadline_s}, weight={self.weight})")


def _check_mixture(mix, what):
    out = []
    for row in mix:
        w, lo, hi = row
        if w <= 0 or lo < 1 or hi < lo:
            raise ValueError(f"bad {what} mixture row {row!r} "
                             f"(want [weight>0, lo>=1, hi>=lo])")
        out.append([float(w), int(lo), int(hi)])
    if not out:
        raise ValueError(f"{what} mixture must have at least one row")
    return out


class TrafficSpec:
    """The workload model (module docstring has the schema).  A spec is
    immutable in spirit: derive variants with :meth:`with_rate` instead
    of mutating — the capacity probe's binary search depends on it."""

    ARRIVAL_KINDS = ("poisson", "onoff")

    def __init__(self, name="traffic", seed=0, arrival=None,
                 duration_s=2.0, prompt_len=((1.0, 4, 12),),
                 output_tokens=((1.0, 4, 8),), shared_prefix=None,
                 classes=(), vocab=(1, 256), temperature=0.8,
                 top_p=0.95, fault_plan=None):
        self.name = str(name)
        self.seed = int(seed)
        self.arrival = dict(arrival or {"kind": "poisson",
                                        "rate_qps": 8.0})
        kind = self.arrival.get("kind")
        if kind not in self.ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {kind!r}; one of "
                             f"{self.ARRIVAL_KINDS}")
        if kind == "poisson" and self.arrival.get("rate_qps", 0) <= 0:
            raise ValueError("poisson arrival needs rate_qps > 0")
        if kind == "onoff":
            for k in ("base_qps", "burst_qps", "period_s"):
                if self.arrival.get(k, 0) <= 0:
                    raise ValueError(f"onoff arrival needs {k} > 0")
            duty = self.arrival.setdefault("duty", 0.25)
            if not 0.0 < duty < 1.0:
                raise ValueError("onoff duty must be in (0, 1)")
        if duration_s <= 0:
            raise ValueError("duration_s must be positive")
        self.duration_s = float(duration_s)
        self.prompt_len = _check_mixture(prompt_len, "prompt_len")
        self.output_tokens = _check_mixture(output_tokens,
                                            "output_tokens")
        self.shared_prefix = dict(shared_prefix) if shared_prefix \
            else {"ratio": 0.0, "length": 0}
        ratio = self.shared_prefix.get("ratio", 0.0)
        if not 0.0 <= ratio <= 1.0:
            raise ValueError("shared_prefix ratio must be in [0, 1]")
        self.classes = [c if isinstance(c, DeadlineClass)
                        else DeadlineClass.from_dict(c)
                        for c in classes] or \
            [DeadlineClass("default", ttft_slo_s=1.0)]
        lo, hi = vocab
        if not 0 <= lo < hi:
            raise ValueError("vocab must be (lo, hi) with 0 <= lo < hi")
        self.vocab = (int(lo), int(hi))
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.fault_plan = dict(fault_plan) if fault_plan else None

    # ------------------------------------------------------- derivation
    def with_rate(self, rate_qps, duration_s=None):
        """A copy of this spec offered at a flat Poisson `rate_qps` —
        what the capacity probe sweeps.  Same seed: the probe varies
        ONLY the offered load."""
        d = self.to_dict()
        d["arrival"] = {"kind": "poisson", "rate_qps": float(rate_qps)}
        if duration_s is not None:
            d["duration_s"] = float(duration_s)
        return TrafficSpec.from_dict(d)

    # ---------------------------------------------------------- JSON
    def to_dict(self):
        return {
            "name": self.name, "seed": self.seed,
            "arrival": dict(self.arrival),
            "duration_s": self.duration_s,
            "prompt_len": [list(r) for r in self.prompt_len],
            "output_tokens": [list(r) for r in self.output_tokens],
            "shared_prefix": dict(self.shared_prefix),
            "classes": [c.to_dict() for c in self.classes],
            "vocab": list(self.vocab),
            "temperature": self.temperature, "top_p": self.top_p,
            "fault_plan": dict(self.fault_plan)
            if self.fault_plan else None,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(name=d.get("name", "traffic"), seed=d.get("seed", 0),
                   arrival=d.get("arrival"),
                   duration_s=d.get("duration_s", 2.0),
                   prompt_len=d.get("prompt_len", ((1.0, 4, 12),)),
                   output_tokens=d.get("output_tokens", ((1.0, 4, 8),)),
                   shared_prefix=d.get("shared_prefix"),
                   classes=d.get("classes", ()),
                   vocab=tuple(d.get("vocab", (1, 256))),
                   temperature=d.get("temperature", 0.8),
                   top_p=d.get("top_p", 0.95),
                   fault_plan=d.get("fault_plan"))

    def __repr__(self):
        return (f"TrafficSpec({self.name!r}, seed={self.seed}, "
                f"{self.arrival}, {self.duration_s}s, "
                f"{len(self.classes)} classes)")


class TraceRequest:
    """One compiled arrival: WHEN (virtual seconds from run start),
    WHAT (prompt tokens + sampling), and the SLO class it is accounted
    under."""

    __slots__ = ("index", "arrive_s", "prompt", "max_new_tokens",
                 "cls", "ttft_slo_s", "deadline_s", "seed",
                 "temperature", "top_p", "shared_prefix")

    def __init__(self, index, arrive_s, prompt, max_new_tokens, cls,
                 ttft_slo_s, deadline_s, seed, temperature, top_p,
                 shared_prefix):
        self.index = int(index)
        self.arrive_s = float(arrive_s)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.cls = str(cls)
        self.ttft_slo_s = float(ttft_slo_s)
        self.deadline_s = deadline_s
        self.seed = int(seed)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.shared_prefix = bool(shared_prefix)

    def sampling_params(self):
        from paddle_tpu_torch.serving.request import SamplingParams
        return SamplingParams(max_new_tokens=self.max_new_tokens,
                              temperature=self.temperature,
                              top_p=self.top_p, seed=self.seed,
                              deadline_s=self.deadline_s)

    def to_dict(self):
        return {"index": self.index,
                "arrive_s": round(self.arrive_s, 9),
                "prompt": list(self.prompt),
                "max_new_tokens": self.max_new_tokens,
                "cls": self.cls, "ttft_slo_s": self.ttft_slo_s,
                "deadline_s": self.deadline_s, "seed": self.seed,
                "temperature": self.temperature, "top_p": self.top_p,
                "shared_prefix": self.shared_prefix}

    def __repr__(self):
        return (f"TraceRequest(#{self.index} @{self.arrive_s:.3f}s, "
                f"{len(self.prompt)}+{self.max_new_tokens} tok, "
                f"cls={self.cls})")


def _pick_range(rng, mixture):
    total = sum(r[0] for r in mixture)
    x = rng.random() * total
    for w, lo, hi in mixture:
        x -= w
        if x <= 0:
            return rng.randint(lo, hi)
    return mixture[-1][1]


def _pick_class(rng, classes):
    total = sum(c.weight for c in classes)
    x = rng.random() * total
    for c in classes:
        x -= c.weight
        if x <= 0:
            return c
    return classes[-1]


def _arrival_times(rng, spec):
    """Arrival instants in [0, duration_s) — exponential gaps at the
    instantaneous rate (for ``onoff``, the rate in force at the moment
    the gap starts; deterministic, no thinning rejection loop)."""
    arr = spec.arrival
    kind = arr["kind"]
    t, out = 0.0, []
    while True:
        if kind == "poisson":
            rate = float(arr["rate_qps"])
        else:
            period = float(arr["period_s"])
            burst_until = period * float(arr["duty"])
            rate = float(arr["burst_qps"]) \
                if (t % period) < burst_until else float(arr["base_qps"])
        t += rng.expovariate(rate)
        if t >= spec.duration_s:
            return out
        out.append(t)


def compile_trace(spec, count=None, start_index=0):
    """Compile `spec` into its deterministic request trace.

    Same spec ⇒ byte-identical trace (assert with :func:`trace_digest`).
    `count` overrides the arrival process with exactly-`count` requests
    at the process's arrival instants (cycling past the duration when
    needed) — the surge injector and unit tests use it; normal runs
    leave it None.
    """
    rng = random.Random(spec.seed * 1000003 + start_index)
    lo, hi = spec.vocab
    prefix_len = int(spec.shared_prefix.get("length", 0))
    prefix_ratio = float(spec.shared_prefix.get("ratio", 0.0))
    prefix = [rng.randrange(lo, hi) for _ in range(prefix_len)]
    times = _arrival_times(rng, spec)
    if count is not None:
        base, times = list(times) or [0.0], []
        for i in range(int(count)):
            cycle, j = divmod(i, len(base))
            times.append(base[j] + cycle * spec.duration_s)
    out = []
    for i, arrive_s in enumerate(times):
        idx = start_index + i
        c = _pick_class(rng, spec.classes)
        plen = _pick_range(rng, spec.prompt_len)
        otok = _pick_range(rng, spec.output_tokens)
        shared = prefix_len > 0 and rng.random() < prefix_ratio
        body_len = max(1, plen - prefix_len) if shared else plen
        prompt = (prefix if shared else []) \
            + [rng.randrange(lo, hi) for _ in range(body_len)]
        out.append(TraceRequest(
            idx, arrive_s, prompt, otok, c.name, c.ttft_slo_s,
            c.deadline_s, seed=spec.seed * 7919 + idx,
            temperature=spec.temperature, top_p=spec.top_p,
            shared_prefix=shared))
    return out


def trace_digest(trace):
    """sha256 over the canonical JSON of the trace — the byte-identity
    proof handle two same-seed compilations must agree on."""
    payload = json.dumps([r.to_dict() for r in trace],
                         sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()
