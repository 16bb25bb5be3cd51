"""paddle_tpu_torch.serving.traffic against the reference package.

Host logic is compared exactly: the same TrafficSpec compiles to the
same trace (``trace_digest`` byte for byte, every request's dict), the
SLO autoscaler takes the same decisions on a scripted telemetry sequence,
and ``probe_capacity`` over one stub router factory gives the same
report. The port's TrafficDriver then serves a seeded trace through a
2-replica port Router on the tiny GPT (CPU, virtual clock) twice, with
identical reports and registry snapshots, and once under a ``qps_surge``
fault plan. The reference's TrafficDriver is not run here: its own
tests cover it, and they are the slowest of the suite.
"""
import numpy as np
import pytest

from paddle_tpu.resilience.faultinject import FaultPlan as RefFaultPlan
from paddle_tpu.serving import traffic as ref_traffic
from paddle_tpu.serving.router import replica as ref_replica
from paddle_tpu.serving.scheduler import \
    AdmissionRejected as RefAdmissionRejected

from paddle_tpu_torch import serving
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.resilience.faultinject import FaultPlan, FaultSpec
from paddle_tpu_torch.serving import traffic
from paddle_tpu_torch.serving.router import Router, RouterConfig, replica
from paddle_tpu_torch.serving.scheduler import AdmissionRejected

SPECS = [
    dict(name="poisson", seed=3, arrival={"kind": "poisson",
                                          "rate_qps": 10.0},
         duration_s=1.0, prompt_len=((1.0, 4, 12),),
         output_tokens=((1.0, 4, 6),),
         classes=({"name": "interactive", "ttft_slo_s": 1.0},)),
    dict(name="onoff", seed=11, arrival={"kind": "onoff", "base_qps": 2.0,
                                         "burst_qps": 40.0, "period_s": 0.5,
                                         "duty": 0.3},
         duration_s=2.0, prompt_len=((3.0, 2, 8), (1.0, 20, 40)),
         output_tokens=((1.0, 1, 3), (2.0, 8, 16)),
         shared_prefix={"ratio": 0.5, "length": 6},
         classes=({"name": "chat", "ttft_slo_s": 0.2, "weight": 3.0},
                  {"name": "batch", "ttft_slo_s": 5.0, "deadline_s": 9.0}),
         vocab=(5, 1000), temperature=0.0, top_p=1.0),
]


@pytest.mark.parametrize("kw", SPECS, ids=[s["name"] for s in SPECS])
def test_compile_trace_equals_reference(kw):
    ours, ref = traffic.TrafficSpec(**kw), ref_traffic.TrafficSpec(**kw)
    assert ours.to_dict() == ref.to_dict()
    assert traffic.TrafficSpec.from_dict(ours.to_dict()).to_dict() == \
        ours.to_dict()
    for args in ({}, {"count": 17}, {"count": 5, "start_index": 4096}):
        got = traffic.compile_trace(ours, **args)
        want = ref_traffic.compile_trace(ref, **args)
        assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
        assert traffic.trace_digest(got) == ref_traffic.trace_digest(want)
    assert traffic.trace_digest(traffic.compile_trace(
        ours.with_rate(33.0))) == ref_traffic.trace_digest(
        ref_traffic.compile_trace(ref.with_rate(33.0)))
    sp = traffic.compile_trace(ours)[0].sampling_params()
    assert isinstance(sp, serving.SamplingParams)


# ----------------------------------------------------------- autoscaler
class _Handle:
    def __init__(self, index, states):
        self.index = index
        self.state = states.ACTIVE
        self.queue = 0
        self.occ = 0.0
        self.admitting = True

    def telemetry(self):
        return {"health": 0, "queue_depth": self.queue, "running": 0,
                "page_occupancy": self.occ}


class _ScriptedRouter:
    """The router surface the autoscaler reads (replicas, parked, park,
    unpark), with telemetry set by the test."""

    def __init__(self, states, n_active, n_parked):
        self.replicas = [_Handle(i, states)
                         for i in range(n_active + n_parked)]
        self._parked = set(range(n_active, n_active + n_parked))
        self.actions = []

    @property
    def parked(self):
        return set(self._parked)

    def park(self, idx):
        self._parked.add(idx)
        self.actions.append(("park", idx))

    def unpark(self, idx):
        self._parked.discard(idx)
        self.actions.append(("unpark", idx))


# (mean queue, occupancy, ttft p99) per observation: a breach streak, a
# dead band, an occupancy breach, an oscillation, a long clear, a TTFT
# breach
SCRIPT = ([(8, 0.1, None)] * 3 + [(2, 0.1, None)] * 2
          + [(0, 0.95, None)] * 3 + [(9, 0.1, None), (0, 0.1, None)] * 3
          + [(0, 0.1, None)] * 12 + [(0, 0.1, 2.0)] * 4
          + [(0, 0.1, 0.1)] * 10)


def _autoscale(mod, states):
    fake = _ScriptedRouter(states, 1, 2)
    t = [0.0]
    feed = [None]
    scaler = mod.SLOAutoscaler(
        fake, slo=mod.SLO(ttft_p99_s=1.0, queue_high=6.0, queue_low=1.0),
        config=mod.AutoscalerConfig(min_replicas=1, up_after=2,
                                    down_after=5, cooldown=2),
        clock=lambda: t[0], ttft_p99_s_fn=lambda: feed[0], name="script")
    decisions = []
    for q, occ, p99 in SCRIPT:
        for h in fake.replicas:
            h.queue, h.occ = q, occ
        feed[0] = p99
        decisions.append(scaler.observe())
        t[0] += 0.01
    snap = scaler.snapshot()
    scaler.release()
    return decisions, fake.actions, snap


def test_autoscaler_decisions_equal_reference():
    got = _autoscale(traffic, replica.ReplicaState)
    want = _autoscale(ref_traffic, ref_replica.ReplicaState)
    assert got == want
    assert "scale_up" in got[0] and "scale_down" in got[0]


# -------------------------------------------------------------- capacity
class _StubRouter:
    """A fleet of ``n`` replicas serving ``per_step`` requests each a
    step, one token a request a step, refusing admissions past ``queue``
    waiting ones: enough router surface for the traffic driver."""

    def __init__(self, n, clock, rejected, per_step=2, queue=3):
        self.n, self.clock, self.rejected = n, clock, rejected
        self.per_step, self.queue = per_step, queue
        self.live = []                 # [rid, max_new, tokens, stream]
        self.finished_results = {}
        self._next = 0

    def add_request(self, prompt, sp, stream=None):
        if len(self.live) >= self.n * (self.per_step + self.queue):
            raise self.rejected("queue_full", "stub fleet full")
        rid = f"rr-{self._next}"
        self._next += 1
        self.live.append([rid, sp.max_new_tokens, 0, stream])
        return rid

    def step(self):
        events = []
        for rec in list(self.live[:self.n * self.per_step]):
            rid, max_new, n, stream = rec
            rec[2] = n + 1
            fin = rec[2] >= max_new
            stream(rid, 7, fin)
            events.append((rid, 7, fin))
            if fin:
                self.live.remove(rec)
                self.finished_results[rid] = type(
                    "R", (), {"output_token_ids": [7] * max_new,
                              "finish_reason": "length"})()
        return events

    def shutdown(self):
        pass


def _probe(mod, rejected):
    spec = mod.TrafficSpec(name="stub", seed=4,
                           arrival={"kind": "poisson", "rate_qps": 5.0},
                           duration_s=1.0, output_tokens=((1.0, 2, 5),))
    rep = mod.probe_capacity(
        lambda n, clock: _StubRouter(n, clock, rejected), spec,
        slo_ttft_s=0.05, replica_counts=(1, 2), qps_lo=1.0, qps_hi=400.0,
        iters=4, quantum_s=0.01, name="stub-capacity")
    return rep.to_dict(), rep.render()


def test_probe_capacity_over_stub_router_equals_reference():
    got = _probe(traffic, AdmissionRejected)
    assert got == _probe(ref_traffic, RefAdmissionRejected)
    rows = got[0]["rows"]
    assert 0.0 < rows[0]["max_qps"] < 400.0          # the search binds
    assert rows[1]["max_qps"] >= rows[0]["max_qps"]
    back = traffic.CapacityReport.from_dict(got[0])
    assert back.to_dict() == got[0] and back.max_qps(2) == rows[1]["max_qps"]


# ------------------------------------------------- driver over the port
ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 16, 32), crash_safe_decode=False)


@pytest.fixture(scope="module")
def tiny_model():
    return GPTForCausalLM(gpt3_tiny(), device="cpu")


@pytest.fixture(scope="module")
def warm_cache(tiny_model, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("traffic_aot"))
    e = serving.LLMEngine(tiny_model, serving.EngineConfig(**ENGINE_KW),
                          device="cpu", program_cache=d)
    e.warmup()
    e.shutdown()
    return d


def _metric_snapshot(name):
    snap = {}
    for m in registry().collect():
        if m.labels.get("traffic") != name:
            continue
        key = (m.name, tuple(sorted(m.labels.items())))
        snap[key] = m.summary() if m.kind == "histogram" else m.value
    return snap


def _run(model, cache, spec, name, replicas=2):
    clock = traffic.VirtualClock()
    router = Router(model, serving.EngineConfig(**ENGINE_KW),
                    num_replicas=replicas,
                    config=RouterConfig(sleep=lambda s: None),
                    program_cache=cache, clock=clock, device="cpu")
    driver = traffic.TrafficDriver(router, spec, clock, quantum_s=0.01,
                                   name=name)
    rep = driver.run()
    snap = _metric_snapshot(name)
    boots = [h.boot_info["warm"] for h in router.replicas]
    driver.release()
    router.shutdown()
    return rep, snap, boots


def test_same_seed_driver_runs_identical_reports_and_metrics(tiny_model,
                                                             warm_cache):
    spec = traffic.TrafficSpec(**SPECS[0])
    rep1, snap1, boots = _run(tiny_model, warm_cache, spec, "det")
    rep2, snap2, _ = _run(tiny_model, warm_cache, spec, "det")
    assert rep1 == rep2 and snap1 == snap2
    assert boots == [True, True]
    assert rep1["offered"] == len(traffic.compile_trace(spec)) > 0
    assert rep1["completed"] == rep1["offered"]
    assert rep1["token_loss"] == 0
    assert rep1["goodput"] + rep1["violations"] == rep1["offered"]


def test_qps_surge_fault_plan_composes(tiny_model, warm_cache):
    plan = FaultPlan([FaultSpec("serving.traffic.tick", "qps_surge", at=3,
                                payload={"requests": 4})], name="surge")
    assert plan.to_dict() == RefFaultPlan.from_dict(plan.to_dict()).to_dict()
    spec = traffic.TrafficSpec(**{**SPECS[0], "duration_s": 0.5,
                                  "fault_plan": plan.to_dict()})
    rep, _, _ = _run(tiny_model, warm_cache, spec, "surge", replicas=1)
    assert rep["surge_injected"] == 1
    assert rep["offered"] == len(traffic.compile_trace(spec)) + 4
    assert rep["token_loss"] == 0 and rep["completed"] == rep["offered"]


def test_onoff_burst_scales_up_through_the_router(tiny_model, warm_cache):
    spec = traffic.TrafficSpec(**{**SPECS[1], "duration_s": 1.0,
                                  "prompt_len": ((1.0, 2, 8),),
                                  "output_tokens": ((1.0, 4, 8),),
                                  "vocab": (1, 256)})
    clock = traffic.VirtualClock()
    router = Router(tiny_model, serving.EngineConfig(**ENGINE_KW),
                    num_replicas=2, config=RouterConfig(sleep=lambda s: None),
                    program_cache=warm_cache, clock=clock, device="cpu")
    router.park(1)
    router.step()                                 # replica 1 drains out
    scaler = traffic.SLOAutoscaler(
        router, slo=traffic.SLO(queue_high=2.0, queue_low=0.5),
        config=traffic.AutoscalerConfig(up_after=2, down_after=400,
                                        cooldown=4), clock=clock)
    driver = traffic.TrafficDriver(router, spec, clock, quantum_s=0.01,
                                   name="burst",
                                   on_tick=lambda d: scaler.observe())
    rep = driver.run()
    snap = scaler.snapshot()
    assert snap["scale_ups"] == 1 and snap["scale_downs"] == 0
    assert len(snap["reaction_times_s"]) == 1
    assert router.replicas[1].boot_info["warm"] is True
    assert router.replicas[1].generation == 1
    assert rep["token_loss"] == 0 and rep["completed"] == rep["offered"]
    scaler.release()
    driver.release()
    router.shutdown()
    np.testing.assert_equal(router.metrics.respawns, 1)
