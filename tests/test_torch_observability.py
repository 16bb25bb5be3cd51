"""paddle_tpu_torch.observability against paddle_tpu.observability, on the
CPU at tiny sizes: the metrics registry (snapshot, quantiles, Prometheus
text byte for byte), the JSONL dump read by the reference's loader,
``TraceContext`` dicts, the recompile log's causes and changes for the
same call sequence, the serving engine's ``serving-aot`` events and span
counts, the scrape endpoint, and telemetry spools the reference's
``merge_spools`` reads.

The span recorder, the recompile log and the registry are process-wide
and shared with the rest of the suite, so these tests read deltas or use
private instances, as the reference's own tests do.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as pnn
from paddle_tpu import observability as robs
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.observability import export as ref_export
from paddle_tpu.observability import fleettrace as ref_fleettrace
from paddle_tpu.observability.metrics import MetricsRegistry as RefRegistry
from paddle_tpu.resilience import HealthMonitor as RefHealth

import paddle_tpu_torch as T
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import export, fleettrace, spans
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.resilience import HealthMonitor

VOCAB = 256
ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 32))
# the reference's AST pass (jit/dy2static.py) runs in its own span when a
# StaticFunction is made; the port has no such pass
REF_ONLY_SPANS = ("dy2static.transform",)


def _span_counts(mod):
    return {k: v["count"] for k, v in mod.recorder().aggregates().items()}


def _delta(before, after):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0) and k not in REF_ONLY_SPANS}


def _new_events(mod, since):
    return [e for e in mod.recompile_log().events() if e.seq > since]


# ------------------------------------------------------------ registry
def _filled(cls):
    """The same operations on a fresh registry of either package."""
    reg = cls()
    rng = np.random.default_rng(0)
    c = reg.counter("req_total", help="requests", labels={"engine": "a"})
    c.inc()
    c.inc(3)
    reg.counter("req_total", labels={"engine": 'b"q\\x\n'}).inc(2)
    g = reg.gauge("depth", help="queue depth")
    g.set(3)
    g.inc(2)
    g.dec(0.25)
    h = reg.histogram("lat_seconds", help="latency", labels={"engine": "a"},
                      cap=64)
    for v in rng.exponential(0.01, 200):
        h.observe(v)
    reg.histogram("empty_seconds")
    reg.register_source("src", lambda: {"x": 1})
    reg.register_source("bad", lambda: 1 / 0)
    return reg, h


def test_registry_matches_reference_byte_for_byte():
    ours, h = _filled(MetricsRegistry)
    ref, ref_h = _filled(RefRegistry)
    qs = (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)
    assert h.quantiles(qs) == ref_h.quantiles(qs)
    assert h.summary() == ref_h.summary()
    assert ours.snapshot() == ref.snapshot()
    assert export.prometheus_text(ours) == ref_export.prometheus_text(ref)
    assert ours.report() == ref.report()
    assert ours.drop_labeled({"engine": "a"}) == \
        ref.drop_labeled({"engine": "a"}) == 2
    assert export.prometheus_text(ours) == ref_export.prometheus_text(ref)
    for reg in (ours, ref):
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("req_total")
        fn = reg._sources["src"]
        reg.unregister_source("src", expected=lambda: {})
        assert "src" in reg.report()
        reg.unregister_source("src", expected=fn)
        assert "src" not in reg.report()
        reg.reset()
    assert ours.snapshot() == ref.snapshot() == {}


def test_dump_jsonl_read_by_reference_loader(tmp_path):
    with obs.span("obs.test.outer", step=1):
        with obs.span("obs.test.inner", tag=np.float32(0.5)):
            pass
    recorded = [s for s in obs.recorder().spans()
                if s.name.startswith("obs.test.")][-2:]
    event = obs.recompile_log().record("fn", "jit", "first compile", [],
                                       trace_ms=1.5)
    reg, _ = _filled(MetricsRegistry)
    path = export.dump_jsonl(str(tmp_path / "obs.jsonl"), spans=recorded,
                             recompiles=[event], registry=reg)
    got, mine = ref_export.load_jsonl(path), export.load_jsonl(path)
    assert got == mine
    assert [s["name"] for s in got["spans"]] == ["obs.test.inner",
                                                 "obs.test.outer"]
    assert got["spans"][1]["attrs"] == {"step": 1}
    assert got["recompiles"] == [json.loads(json.dumps(event.to_dict()))]
    assert [(m["name"], m["type"], m["labels"]) for m in got["metrics"]] == \
        [(m.name, m.kind, m.labels) for m in reg.collect()]
    ref_reg, _ = _filled(RefRegistry)
    want = [{"name": m.name, "type": m.kind, "labels": m.labels,
             "value": m.summary() if m.kind == "histogram" else m.value}
            for m in ref_reg.collect()]
    assert [{k: m[k] for k in ("name", "type", "labels", "value")}
            for m in got["metrics"]] == want


def test_chrome_trace_matches_reference():
    dicts = [{"name": "a", "start_ns": 1000, "dur_ns": 500, "depth": 0,
              "thread_id": 7, "attrs": {"k": 1}, "trace": "t", "span": "s1"},
             {"name": "b", "start_ns": 1200, "dur_ns": 100, "depth": 1,
              "thread_id": 9, "trace": "t", "span": "s2", "parent": "s1"}]
    events = [{"seq": 1, "t_ns": 1100, "fn": "f", "kind": "jit",
               "cause": "shape change in x",
               "changes": [{"arg": "x", "kind": "shape", "before": [1],
                            "after": [2]}]}]
    assert export.chrome_trace(dicts, events) == \
        ref_export.chrome_trace(dicts, events)


# ---------------------------------------------------------------- spans
def test_trace_context_round_trips_reference_dicts():
    ref_ctx = robs.TraceContext("req-7", "abc.3")
    ctx = obs.TraceContext.from_dict(ref_ctx.to_dict())
    assert ctx.to_dict() == ref_ctx.to_dict() == {"t": "req-7", "s": "abc.3"}
    assert robs.TraceContext.from_dict(ctx.to_dict()).to_dict() == \
        ref_ctx.to_dict()
    assert obs.TraceContext.from_dict(None) is None
    fresh = obs.TraceContext.new("smoke")
    assert fresh.trace_id.startswith("smoke-") and \
        fresh.parent_span_id is None
    with obs.use_context(ctx):
        assert obs.current_context() is ctx
        with obs.span("obs.test.traced") as outer:
            with obs.span("obs.test.child"):
                pass
    assert obs.current_context() is None
    child, parent = [s for s in obs.recorder().spans()
                     if s.name in ("obs.test.traced",
                                   "obs.test.child")][-2:]
    assert child.trace_id == parent.trace_id == "req-7"
    assert parent.parent_id == "abc.3" and parent.span_id == outer.span_id
    assert child.parent_id == outer.span_id
    assert child.to_dict()["parent"] == outer.span_id


def test_quiet_and_held_spans_and_counters():
    reg = obs.registry()
    c = reg.counter("obs_test_held_total")
    before = _span_counts(obs).get("obs.test.held", 0)
    with spans.quiet():
        with obs.span("obs.test.held"):
            c.inc()
    with spans.held() as dropped:
        with obs.span("obs.test.held"):
            c.inc(2)
    assert len(dropped) == 2
    with spans.held() as kept:
        with obs.span("obs.test.held"):
            c.inc(5)
    assert c.value == 0 and \
        _span_counts(obs).get("obs.test.held", 0) == before
    kept.commit()
    assert c.value == 5 and \
        _span_counts(obs)["obs.test.held"] == before + 1
    prev = obs.set_enabled(False)
    try:
        with obs.span("obs.test.held"):
            pass
    finally:
        obs.set_enabled(prev)
    assert _span_counts(obs)["obs.test.held"] == before + 1


def test_span_lands_in_a_torch_profile():
    from torch.profiler import profile
    with profile() as prof:
        with obs.span("obs.test.profiled"):
            torch.ones(4).sum()
    assert "obs.test.profiled" in [e.key for e in prof.key_averages()]
    with obs.span("obs.test.unprofiled") as s:
        assert s._ann is None


# ----------------------------------------------------------- recompiles
@pytest.fixture(scope="module")
def linear_init():
    P.seed(0)
    model = pnn.Linear(6, 3)
    return {k: np.asarray(t._value) for k, t in model.state_dict().items()}


def _linear_step(pkg, init):
    """(step, tensor maker) of a guarded AdamW Linear(6, 3) step."""
    if pkg == "ref":
        model = pnn.Linear(6, 3)
        model.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
        opt = P.optimizer.AdamW(learning_rate=0.05,
                                parameters=model.parameters(), guard=True)
        jit = P.jit.to_static

        def make(a, bf16=False):
            t = P.to_tensor(a)
            return t.astype("bfloat16") if bf16 else t
    else:
        model = T.nn.Linear(6, 3, device="cpu")
        load_numpy_state_dict(model, init)
        opt = T.optimizer.AdamW(learning_rate=0.05,
                                parameters=model.named_parameters(),
                                guard=True)
        jit = T.jit.to_static

        def make(a, bf16=False):
            t = torch.tensor(a)
            return t.to(torch.bfloat16) if bf16 else t

    @jit(guard=True)
    def train_step(X, y, scale=1.0):
        opt.clear_grad()
        loss = ((model(X) - y) ** 2).mean() * scale
        loss.backward()
        opt.step()
        return loss

    return train_step, make


def _lazy_optimizer(pkg):
    """(an SGD-with-momentum optimizer over a spare parameter, made before
    the first call, and an eager step of it): the step makes its lazy
    velocity, which registers state between two calls."""
    if pkg == "ref":
        w = P.create_parameter([2], "float32")
        opt = P.optimizer.Momentum(0.1, momentum=0.9, parameters=[w])

        def step():
            w.grad = P.to_tensor(np.ones(2, np.float32))
            opt.step()
    else:
        w = torch.nn.Parameter(torch.zeros(2))
        opt = T.optimizer.Momentum(0.1, momentum=0.9, parameters=[w])

        def step():
            w.grad = torch.ones(2)
            opt.step()
    return opt, step


CHANGES = {
    "first": [],
    "repeat": [((8, False), ())],
    "shape": [((5, False), ())],
    "dtype": [((8, True), ())],
    "static": [((8, False), (2.0,)), ((8, False), (3.0,))],
    "tree": [((8, False), (2.0,))],
    "state": ["state", ((8, False), ())],
}


def _recompile_run(pkg, init, calls):
    mod = robs if pkg == "ref" else obs
    since = mod.recompile_log().count
    step, make = _linear_step(pkg, init)
    _spare, lazy_step = _lazy_optimizer(pkg)
    spans_before = _span_counts(mod)
    rng = np.random.default_rng(0)

    def call(n, bf16, extra):
        X = rng.standard_normal((n, 6)).astype(np.float32)
        y = rng.standard_normal((n, 3)).astype(np.float32)
        step(make(X), make(y, bf16), *extra)

    call(8, False, ())
    for c in calls:
        if c == "state":
            lazy_step()
        else:
            call(*c[0], c[1])
    events = _new_events(mod, since)
    return events, _delta(spans_before, _span_counts(mod))


@pytest.mark.parametrize("change", list(CHANGES))
def test_recompile_events_match_reference(linear_init, change):
    """The same call sequence gives the same events (fn, kind, cause,
    changes) and the same span counts in both packages; "state" is an
    optimizer's lazy state registered between two calls (an eager step
    of another optimizer). A state change's ``before``/``after`` are each
    package's own registry versions."""
    got, got_spans = _recompile_run("port", linear_init, CHANGES[change])
    want, want_spans = _recompile_run("ref", linear_init, CHANGES[change])

    def view(e):
        return (e.fn, e.kind, e.cause, [
            {k: v for k, v in c.items()
             if c["kind"] != "state" or k in ("arg", "kind")}
            for c in e.changes])

    assert [view(e) for e in got] == [view(e) for e in want]
    assert got[0].cause == "first compile of this function"
    assert [e.cache_size for e in got] == [e.cache_size for e in want]
    for e in got:
        assert e.trace_ms >= 0 and e.compile_ms >= 0
        for c in e.changes:
            if c["kind"] == "state":
                assert c["before"] < c["after"]
    assert got_spans == want_spans
    if change == "dtype":
        assert got[1].changes == [{"arg": "y", "kind": "dtype",
                                   "before": "float32",
                                   "after": "bfloat16"}]


def test_device_change_is_named():
    from paddle_tpu_torch.jit.api import _TENSOR
    from paddle_tpu_torch.observability.recompile import diff_keys
    old = (None, (((2, 3), torch.float32, torch.device("cpu")),),
           (_TENSOR,), 1)
    new = (None, (((2, 3), torch.float32, torch.device("cuda", 0)),),
           (_TENSOR,), 1)
    assert diff_keys(new, old, ["x"], _TENSOR) == [
        {"arg": "x", "kind": "device", "before": "cpu", "after": "cuda:0"}]


@pytest.fixture(scope="module")
def gpt_pair():
    """A reference and a port tiny GPT on one set of weights."""
    P.seed(0)
    ref = RefGPT(ref_tiny(fused_ln=True))
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(port, sd)
    return ref, port, sd


def test_to_static_span_counts_match_reference(gpt_pair):
    """A first call, two cached calls and a new batch shape of the tiny
    GPT's AdamW step: ``jit.gpt_step`` once a call, ``optimizer.step``
    as often as the reference traces (2 at the first call, whose
    discovery registers the moments, 1 at the new shape)."""
    _, _, sd = gpt_pair
    ref = RefGPT(ref_tiny(fused_ln=True))
    ref.set_state_dict({k: P.to_tensor(v) for k, v in sd.items()})
    ref_opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=ref.parameters())
    port = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(port, sd)
    opt = T.optimizer.AdamW(learning_rate=1e-3,
                            parameters=port.named_parameters())

    @P.jit.to_static
    def gpt_step(ids, labels):
        ref_opt.clear_grad()
        loss = P.nn.functional.cross_entropy(
            ref(ids).reshape([-1, VOCAB]), labels.reshape([-1]))
        loss.backward()
        ref_opt.step()
        return loss

    ref_step = gpt_step

    @T.jit.to_static
    def gpt_step(ids, labels):
        opt.clear_grad()
        loss = F.cross_entropy(port(ids).reshape([-1, VOCAB]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, VOCAB, (2, n)) for n in (32, 32, 32, 16)]
    counts, ref_counts = _span_counts(obs), _span_counts(robs)
    for b in batches:
        gpt_step(torch.tensor(b), torch.tensor(b))
        ref_step(P.to_tensor(b), P.to_tensor(b))
    got, want = _delta(counts, _span_counts(obs)), \
        _delta(ref_counts, _span_counts(robs))
    assert got == want == {"jit.gpt_step": 4, "optimizer.step": 3}


# -------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engines(gpt_pair):
    ref, port, _ = gpt_pair
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, VOCAB, n)]
               for n in (3, 7, 12, 5)]
    return ref, port, prompts


def _serve(pkg, model, prompts, name, ctx=None, over_bound=False):
    """Serve ``prompts`` on a fresh engine named ``name``: (tokens, new
    recompile events, span-count delta, compile counter)."""
    mod, srv = (robs, ref_serving) if pkg == "ref" else (obs, serving)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    since, counts = mod.recompile_log().count, _span_counts(mod)
    eng = srv.LLMEngine(model, srv.EngineConfig(**ENGINE_KW),
                        metrics_name=name, **kw)
    try:
        sps = [srv.SamplingParams(max_new_tokens=6) for _ in prompts]
        with mod.use_context(ctx):
            res = eng.generate(prompts, sps)
        if over_bound:
            eng.metrics.compile_bound = eng.metrics.compile_count
            with pytest.raises(RuntimeError, match="recompile storm"):
                eng.warmup()
        compiles = mod.registry().counter(
            "serving_compile_total", labels={"engine": name}).value
    finally:
        eng.shutdown()
    return ([r.output_token_ids for r in res], _new_events(mod, since),
            _delta(counts, _span_counts(mod)), compiles)


def test_engine_aot_events_match_reference(engines):
    """The engine's program builds are ``serving-aot`` events, equal in
    order to the reference's; one built past the bound is the last
    event in both, and ``serving_compile_total`` counts it."""
    ref, port, prompts = engines
    # two prompts of bucket 8 build 4 programs; warmup() then builds the
    # prefill of bucket 32 past a bound of 4
    tokens, got, _, compiles = _serve("port", port, prompts[:2], "obs-aot",
                                      over_bound=True)
    ref_tokens, want, _, ref_compiles = _serve("ref", ref, prompts[:2],
                                               "obs-aot", over_bound=True)
    assert tokens == ref_tokens

    def view(e):
        return (e.fn, e.kind, e.cause, e.changes, e.cache_size, e.attrs)

    assert [view(e) for e in got] == [view(e) for e in want]
    assert [e.fn for e in got] == ["prefill/8", "sample/1", "decode",
                                   "sample/4", "prefill/32"]
    assert got[-1].attrs == {"compile_bound": 5, "engine": "obs-aot"}
    assert got[-1].cache_size == 5
    assert compiles == ref_compiles == 5
    assert all(e.compile_ms >= 0 for e in got)


@pytest.mark.parametrize("traced", [False, True])
def test_engine_span_counts_match_reference(engines, traced):
    """Span counts by name after a generate() of 4 requests, equal to the
    reference's; under a TraceContext each request also finishes in a
    ``serving.finish`` span of that trace."""
    ref, port, prompts = engines
    ctx = obs.TraceContext("obs-test") if traced else None
    ref_ctx = robs.TraceContext("obs-test") if traced else None
    tokens, _, got, _ = _serve("port", port, prompts, "obs-spans", ctx)
    ref_tokens, _, want, _ = _serve("ref", ref, prompts, "obs-spans",
                                    ref_ctx)
    assert tokens == ref_tokens
    assert got == want
    assert got["serving.prefill"] == 4 and \
        got.get("serving.finish", 0) == (4 if traced else 0)
    if traced:
        fin = [s for s in obs.recorder().spans()
               if s.name == "serving.finish"][-4:]
        assert {s.trace_id for s in fin} == {"obs-test"}


def test_spans_off_serve_the_same_tokens(engines):
    _, port, prompts = engines
    on = _serve("port", port, prompts, "obs-on")[0]
    prev = obs.set_enabled(False)
    try:
        off, _, counts, _ = _serve("port", port, prompts, "obs-off")
    finally:
        obs.set_enabled(prev)
    assert on == off and counts == {}


def test_engine_source_scrape_and_release(engines):
    """The engine's snapshot is a registry source and its series scrape
    over 127.0.0.1; shutdown removes both."""
    _, port, prompts = engines
    eng = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                            device="cpu", metrics_name="obs-scrape")
    default = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                                device="cpu")
    assert default._metrics_name.startswith("serving.engine")
    default.shutdown()
    eng.generate(prompts, [serving.SamplingParams(max_new_tokens=4)] * 4)
    report = obs.registry().report()["obs-scrape"]
    assert report["requests"] == eng.metrics.snapshot()["requests"] == {
        "received": 4, "admitted": 4, "finished": 4, "evicted": 0,
        "rejected": 0, "expired": 0, "adopted": 0}
    with export.serve_prometheus(port=0) as server:
        assert server.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            body = resp.read().decode()
    for line in ('serving_compile_total{engine="obs-scrape"} 5',
                 'serving_queue_depth{engine="obs-scrape"} 0',
                 'serving_health_state{engine="obs-scrape"} 0',
                 'serving_ttft_seconds_count{engine="obs-scrape"} 4'):
        assert line in body, line
    assert 'serving_ttft_seconds{engine="obs-scrape",quantile="0.5"}' in body
    eng.shutdown()
    assert "obs-scrape" not in obs.registry().report()
    assert 'engine="obs-scrape"' not in export.prometheus_text()


def test_health_gauge_and_spans_match_reference():
    reg, ref_reg = MetricsRegistry(), RefRegistry()
    gauge = reg.gauge("serving_health_state", labels={"engine": "h"})
    ref_gauge = ref_reg.gauge("serving_health_state", labels={"engine": "h"})
    seen, ref_seen = [], []
    ours = HealthMonitor(gauge=gauge,
                         on_transition=lambda a, b, p: seen.append(int(b)))
    ref = RefHealth(gauge=ref_gauge,
                    on_transition=lambda a, b, p: ref_seen.append(int(b)))
    counts, ref_counts = _span_counts(obs), _span_counts(robs)
    values = []
    for p in (0.5, 0.86, 0.9, 0.98, 0.9, 0.8, 0.6, 0.99, 0.84, 0.5):
        assert int(ours.update(p)) == int(ref.update(p))
        values.append((gauge.value, ref_gauge.value))
    assert all(a == b for a, b in values)
    assert seen == ref_seen == [1, 2, 1, 0, 2, 1, 0]
    assert _delta(counts, _span_counts(obs)) == \
        _delta(ref_counts, _span_counts(robs)) == {"resilience.health": 7}


# --------------------------------------------------------------- spools
def test_spool_merged_by_both_packages(engines, tmp_path, monkeypatch):
    """A spool armed around a traced generate(): the reference's and the
    port's merge_spools read it alike, its Chrome trace holds the
    engine's spans and build events, a request's timeline has its
    prefill, and the flight recorder finds nothing in flight."""
    _, port, prompts = engines
    spool = fleettrace.arm_spool(str(tmp_path), rank=0,
                                 metrics_interval_s=0.05)
    try:
        assert fleettrace.arm_spool(str(tmp_path)) is spool
        _serve("port", port, prompts, "obs-spool",
               obs.TraceContext("spool-trace"))
    finally:
        fleettrace.disarm()
    assert fleettrace.active_spool() is None
    ours, ref = fleettrace.merge_spools(str(tmp_path)), \
        ref_fleettrace.merge_spools(str(tmp_path))
    assert ours.summary() == ref.summary()
    assert ours.chrome_trace() == ref.chrome_trace()
    assert ours.prometheus_text() == ref.prometheus_text()
    names = {e["name"] for e in ours.chrome_trace()["traceEvents"]}
    assert {"serving.prefill", "serving.decode", "serving.finish",
            "recompile:decode"} <= names
    line = fleettrace.request_timeline(str(tmp_path), "req-0")
    assert line == ref_fleettrace.request_timeline(str(tmp_path), "req-0")
    assert line["trace"] == "spool-trace" and line["stages"]["prefill_s"] > 0
    rec = fleettrace.flight_record(str(tmp_path), 0)
    assert rec["in_flight_requests"] == [] and rec["spans_total"] > 0
    assert rec["last_metrics"] is not None
    # a client arms the KV clock handshake: the reference rank's offset
    from paddle_tpu_torch.resilience.fleet import LocalKVClient
    armed = fleettrace.arm_spool(str(tmp_path / "armed"), rank=0,
                                 client=LocalKVClient())
    fleettrace.disarm()
    (proc,) = fleettrace.merge_spools(str(tmp_path / "armed")).processes
    assert armed.rank == 0 and proc.clock["offset_ns"] == 0
    assert fleettrace.active_spool() is None
    monkeypatch.setenv(fleettrace.SPOOL_ENV, str(tmp_path))
    monkeypatch.setenv(fleettrace.SUPPRESS_ENV, "off")
    assert fleettrace.arm_from_env(rank=0) is None
