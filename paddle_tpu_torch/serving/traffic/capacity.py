"""Capacity probe: binary-search the largest sustained QPS per replica
count, reported as a JSON-able :class:`CapacityReport` (counterpart of
``paddle_tpu/serving/traffic/capacity.py``).

"Max sustained QPS at p99 TTFT <= X" per replica count, where
*sustained* means the offered load finished with goodput >=
``goodput_min`` and a TTFT p99 within the SLO. Every probe rides the
deterministic virtual-time driver, so the whole search replays: the same
spec and factory give the same report, byte for byte.

Chaos composes: hand ``probe_capacity`` a ``fault_plan`` (or put one on
the spec) and every probe runs under the injected faults.
"""
from __future__ import annotations

from paddle_tpu_torch.serving.traffic.driver import (TrafficDriver,
                                                     VirtualClock)
from paddle_tpu_torch.serving.traffic.workload import TrafficSpec

__all__ = ["CapacityReport", "probe_capacity", "run_traffic"]


class CapacityReport:
    """Per-replica-count capacity rows + the search parameters that
    produced them (FaultPlan-style ``to_dict``/``from_dict``)."""

    def __init__(self, name, slo_ttft_s, goodput_min, rows,
                 fault_plan=None):
        self.name = str(name)
        self.slo_ttft_s = float(slo_ttft_s)
        self.goodput_min = float(goodput_min)
        self.rows = [dict(r) for r in rows]
        self.fault_plan = dict(fault_plan) if fault_plan else None

    def max_qps(self, replicas):
        for r in self.rows:
            if r["replicas"] == replicas:
                return r["max_qps"]
        raise KeyError(f"no capacity row for {replicas} replicas")

    def to_dict(self):
        return {"name": self.name, "slo_ttft_s": self.slo_ttft_s,
                "goodput_min": self.goodput_min,
                "rows": [dict(r) for r in self.rows],
                "fault_plan": dict(self.fault_plan)
                if self.fault_plan else None}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("name", "capacity"), d["slo_ttft_s"],
                   d.get("goodput_min", 0.95), d.get("rows", ()),
                   d.get("fault_plan"))

    def render(self):
        """Human-readable table."""
        lines = [
            f"== capacity {self.name} — sustained QPS at p99 TTFT <= "
            f"{self.slo_ttft_s * 1e3:.0f}ms, goodput >= "
            f"{100 * self.goodput_min:.0f}%"
            + (f", under fault plan "
               f"{self.fault_plan.get('name', '?')}"
               if self.fault_plan else "") + " " + "=" * 8,
            f"  {'replicas':>8s} {'max QPS':>9s} {'goodput':>8s} "
            f"{'p99 TTFT ms':>12s} {'probes':>7s}",
        ]
        for r in self.rows:
            gp = r.get("goodput_frac")
            p99 = r.get("ttft_p99_ms")
            gp_s = f"{100 * gp:>7.1f}%" if gp is not None else f"{'-':>8s}"
            p99_s = f"{p99:>12.1f}" if p99 is not None else f"{'-':>12s}"
            lines.append(f"  {r['replicas']:>8d} {r['max_qps']:>9.2f} "
                         f"{gp_s} {p99_s} {r.get('probes', 0):>7d}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"CapacityReport({self.name!r}, "
                f"{len(self.rows)} replica counts, "
                f"slo={self.slo_ttft_s}s)")


def run_traffic(router_factory, spec, replicas, quantum_s=0.005,
                on_tick_factory=None, **driver_kw):
    """One fresh deterministic traffic run: new VirtualClock, new
    router from ``router_factory(replicas, clock)``, full trace replay,
    clean shutdown.  Returns the driver's report dict."""
    clock = VirtualClock()
    router = router_factory(replicas, clock)
    driver = TrafficDriver(router, spec, clock, quantum_s=quantum_s,
                           **driver_kw)
    if on_tick_factory is not None:
        driver.on_tick = on_tick_factory(router, clock, driver)
    try:
        return driver.run()
    finally:
        driver.release()
        router.shutdown()


def _sustained(report, slo_ttft_s, goodput_min):
    p99 = report.get("ttft_p99_ms")
    return (report["goodput_frac"] >= goodput_min
            and p99 is not None and p99 <= slo_ttft_s * 1e3)


def probe_capacity(router_factory, spec, slo_ttft_s=0.5,
                   replica_counts=(1, 2), qps_lo=0.5, qps_hi=64.0,
                   iters=5, goodput_min=0.95, quantum_s=0.005,
                   fault_plan=None, name=None):
    """Binary-search max sustained QPS for each replica count.

    ``router_factory(num_replicas, clock)`` must return a fresh
    :class:`~paddle_tpu_torch.serving.router.Router` built ON that clock
    (share one AOT cache dir across calls so probes boot warm).  The
    search brackets [`qps_lo`, `qps_hi`]: a load unsustainable at
    `qps_lo` reports ``max_qps 0.0``; one sustainable at `qps_hi`
    reports `qps_hi` (widen the bracket for bigger fleets).  With
    `fault_plan` (or ``spec.fault_plan``) every probe runs under the
    injected faults — capacity under chaos.
    """
    if not isinstance(spec, TrafficSpec):
        spec = TrafficSpec.from_dict(spec)
    if fault_plan is not None:
        d = spec.to_dict()
        d["fault_plan"] = dict(fault_plan)
        spec = TrafficSpec.from_dict(d)
    rows = []
    for n in replica_counts:
        probes = 0

        def measure(qps):
            nonlocal probes
            probes += 1
            return run_traffic(router_factory, spec.with_rate(qps), n,
                               quantum_s=quantum_s,
                               name=f"{spec.name}-cap{n}r")

        lo_rep = measure(qps_lo)
        if not _sustained(lo_rep, slo_ttft_s, goodput_min):
            rows.append({"replicas": int(n), "max_qps": 0.0,
                         "goodput_frac": lo_rep["goodput_frac"],
                         "ttft_p99_ms": lo_rep.get("ttft_p99_ms"),
                         "probes": probes})
            continue
        hi_rep = measure(qps_hi)
        if _sustained(hi_rep, slo_ttft_s, goodput_min):
            rows.append({"replicas": int(n), "max_qps": float(qps_hi),
                         "goodput_frac": hi_rep["goodput_frac"],
                         "ttft_p99_ms": hi_rep.get("ttft_p99_ms"),
                         "probes": probes})
            continue
        lo, hi = float(qps_lo), float(qps_hi)
        best = lo_rep
        for _ in range(int(iters)):
            mid = (lo + hi) / 2.0
            rep = measure(mid)
            if _sustained(rep, slo_ttft_s, goodput_min):
                lo, best = mid, rep
            else:
                hi = mid
        rows.append({"replicas": int(n), "max_qps": round(lo, 3),
                     "goodput_frac": best["goodput_frac"],
                     "ttft_p99_ms": best.get("ttft_p99_ms"),
                     "probes": probes})
    return CapacityReport(name or f"{spec.name}-capacity", slo_ttft_s,
                          goodput_min, rows,
                          fault_plan=spec.fault_plan)
