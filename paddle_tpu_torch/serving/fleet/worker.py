"""Serving-fleet worker: the per-process entry point of the multi-process
serving fleet (counterpart of ``paddle_tpu/serving/fleet/worker.py``).

Started one fresh process a rank::

    python -m paddle_tpu_torch.distributed.launch --master HOST:PORT \\
        --nnodes N --rank R paddle_tpu_torch/serving/fleet/worker.py \\
        scenario.json

The scenario (JSON) assigns roles by rank and says what to build:

- ``controller_rank`` (default 0; rank 0 hosts the store, so the store
  outlives every other rank): serves the monolithic reference run first
  (its warm-up fills the shared AOT cache ``cache_dir``, so every replica
  boot, respawns too, loads instead of building), then drives a
  :class:`~paddle_tpu_torch.serving.fleet.ServingFleet` through
  ``prompts`` / ``sampling``, a disaggregated run of
  ``disagg_prompts`` / ``disagg_sampling`` between two live replicas,
  and an audit of every live replica, and writes ``controller.json`` to
  ``out_dir``; with a ``traffic`` key it replays that
  :class:`~paddle_tpu_torch.serving.traffic.TrafficSpec` through the
  fleet instead (:func:`run_traffic_controller`);
- ``worker_ranks`` / ``spare_ranks``: a
  :class:`~paddle_tpu_torch.serving.fleet.ReplicaServer` (spares idle
  until a respawn's ``boot`` claims them) with a heartbeat publisher
  shipping the engine's telemetry; each writes ``replica-rank<N>.json``
  on a clean shutdown.

The model: ``model`` = ``{"preset": "gpt3_1p3b" | "gpt3_tiny" | ...,
"kwargs": {...}, "dtype": "bfloat16" | "float32"}``, its weights drawn
from ``seed`` on the device (the same in every process) or, with
``weights``, loaded from that ``.npz`` of ``{name: array}``
(``framework/io.load_numpy_state_dict``). ``engine`` holds
``EngineConfig``'s keys (``dtype`` a name); ``device`` is ``"cuda"``
unless the scenario says ``"cpu"``. ``faults`` maps a rank to
``FaultSpec`` dicts (``serving.fleet.step``: ``rank_kill``, ``wedge``);
``serve_budget_s`` bounds the serving loop and ``finalize_s`` the
controller's check-out wait. The fleet's budgets come from the
``PTPU_FLEET_*`` environment (``resilience/fleet.py``), telemetry
spooling from ``PTPU_OBS_SPOOL_DIR``.

Every process leaves through ``fleet.finalize()`` and ``os._exit``: once
a peer died by design, nothing may wait for it.
"""
import gc
import json
import os
import sys
import time


def _load_cfg():
    with open(sys.argv[1]) as fh:
        return json.load(fh)


def _write_result(out_dir, name, result):
    path = os.path.join(out_dir, name)
    with open(path + ".tmp", "w") as fh:
        json.dump(result, fh, default=str)
    os.replace(path + ".tmp", path)


def _sps(dicts):
    from paddle_tpu_torch.serving.fleet import wire
    return [wire.sp_from_dict(d) for d in dicts]


def _device(cfg):
    return cfg.get("device", "cuda")


def build_model(cfg):
    """The scenario's model on its device: drawn from ``seed``, or the
    ``weights`` file's arrays."""
    import numpy as np
    import torch

    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.models import gpt
    spec = cfg["model"]
    device = _device(cfg)
    mc = getattr(gpt, spec.get("preset", "gpt3_tiny"))(
        **spec.get("kwargs", {}))
    dtype = getattr(torch, spec.get("dtype", "float32"))
    model = gpt.GPTForCausalLM(
        mc, device=device, dtype=dtype,
        generator=torch.Generator(device).manual_seed(int(cfg["seed"])))
    if cfg.get("weights"):
        with np.load(cfg["weights"]) as z:
            load_numpy_state_dict(model, {k: z[k] for k in z.files})
    return model


def engine_config(cfg):
    import torch

    from paddle_tpu_torch.serving import EngineConfig
    kw = dict(cfg["engine"])
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    return EngineConfig(**kw)


def _peak_bytes(device):
    import torch
    if str(device).startswith("cuda"):
        return {"peak_allocated": int(torch.cuda.max_memory_allocated()),
                "peak_reserved": int(torch.cuda.max_memory_reserved())}
    return {}


# ------------------------------------------------------------ replica
def run_replica(cfg, grank):
    from paddle_tpu_torch.resilience import faultinject
    from paddle_tpu_torch.resilience import fleet as flt
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.serving.fleet.server import ReplicaServer

    specs = [faultinject.FaultSpec(**d)
             for d in (cfg.get("faults") or {}).get(str(grank), [])]
    if specs:
        faultinject.install(faultinject.FaultInjector(
            faultinject.FaultPlan(specs, seed=grank,
                                  name="fleetserving-chaos")))

    def factory(payload):
        return LLMEngine(build_model(cfg), engine_config(cfg),
                         device=_device(cfg),
                         program_cache=cfg.get("cache_dir"),
                         metrics_name=f"serving.fleet.r{grank}")

    server = ReplicaServer(flt.get_client(), grank, factory)

    def telemetry():
        tel = server.telemetry()
        tel.update(_peak_bytes(_device(cfg)))
        return tel

    flt.install_publisher(
        flt.HeartbeatPublisher(payload_fn=telemetry).start())
    server.serve()

    result = {"role": "replica", "rank": grank, "steps": server.steps,
              "requests_served": server.requests_served}
    eng = server.engine
    if eng is not None:
        m = eng.metrics
        result.update(compiled=int(m.compile_count),
                      bound=int(m.compile_bound),
                      cache_loads=int(m.aot_cache_loads),
                      generated_tokens=int(m.generated_tokens),
                      **_peak_bytes(_device(cfg)))
    _write_result(cfg["out_dir"], f"replica-rank{grank}.json", result)


def _fleet(cfg):
    from paddle_tpu_torch.resilience import fleet as flt
    from paddle_tpu_torch.serving.fleet import (FleetServingConfig,
                                                ServingFleet)
    from paddle_tpu_torch.serving.router.router import RouterConfig
    flt.install_publisher(flt.HeartbeatPublisher().start())
    return ServingFleet(
        flt.get_client(),
        FleetServingConfig(cfg["worker_ranks"], cfg.get("spare_ranks", ()),
                           boot_payload={}),
        router_config=RouterConfig(sleep=lambda s: None))


def _warm_cache(cfg, name):
    """The monolithic engine over the shared AOT cache, warmed up: its
    cold builds fill the cache every replica boots from."""
    from paddle_tpu_torch.serving import LLMEngine
    eng = LLMEngine(build_model(cfg), engine_config(cfg),
                    device=_device(cfg), program_cache=cfg.get("cache_dir"),
                    metrics_name=name)
    t0 = time.perf_counter()
    boot = eng.warmup()
    boot["boot_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return eng, boot


def _free():
    """Give this process's freed device memory back to the card."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ----------------------------------------------------- traffic mode
class _FleetStepAdapter:
    """Router facade for the traffic driver over a ServingFleet:
    stepping goes through :meth:`ServingFleet.step` (telemetry refresh
    and failover live there), everything else is the fleet's router."""

    def __init__(self, sfleet):
        self._sfleet = sfleet

    def step(self):
        return self._sfleet.step()

    def __getattr__(self, name):
        return getattr(self._sfleet.router, name)


def run_traffic_controller(cfg, grank):
    """Replay the scenario's seeded ``traffic`` spec through the fleet
    (arrivals on the driver's virtual clock, service and verdicts on the
    wall clock) and report the driver's goodput and token accounting
    beside the fleet's failover evidence."""
    from paddle_tpu_torch.serving import traffic
    ref, _boot = _warm_cache(cfg, "serving.fleet.warmcache")
    ref.shutdown()
    del ref
    _free()
    sfleet = _fleet(cfg)
    spec = traffic.TrafficSpec.from_dict(cfg["traffic"])
    clock = traffic.VirtualClock()
    driver = traffic.TrafficDriver(
        _FleetStepAdapter(sfleet), spec, clock,
        quantum_s=float(cfg.get("quantum_s", 0.01)), name="fleet-traffic")
    report = driver.run()
    driver.release()
    snap = sfleet.router.snapshot()
    result = {"role": "controller", "rank": grank, "traffic": report,
              "detections": sfleet.detections(),
              "respawn_ms": sfleet.respawn_ms,
              "boots": [dict(h.boot_info or {})
                        for h in sfleet.router.replicas],
              "snapshot": {k: snap.get(k)
                           for k in ("failovers", "respawns", "adoptions",
                                     "spillovers", "requests_finished")}}
    sfleet.shutdown()
    _write_result(cfg["out_dir"], "controller.json", result)


# --------------------------------------------------------- controller
def _collector():
    rec = {"tokens": [], "fins": 0}

    def _stream(rid, tok, fin):
        if tok is not None:
            rec["tokens"].append(int(tok))
        if fin:
            rec["fins"] += 1

    return rec, _stream


def run_controller(cfg, grank):
    from paddle_tpu_torch.resilience import fleet as flt
    from paddle_tpu_torch.serving.fleet import DisaggregatedEngine
    from paddle_tpu_torch.serving.scheduler import AdmissionRejected

    prompts = [[int(t) for t in p] for p in cfg["prompts"]]
    sps = _sps(cfg["sampling"])
    dprompts = [[int(t) for t in p] for p in cfg.get("disagg_prompts", [])]
    dsps = _sps(cfg.get("disagg_sampling", []))

    # the monolithic reference: the fleet's yardstick, same weights
    ref_engine, ref_boot = _warm_cache(cfg, "serving.fleet.reference")
    t0 = time.perf_counter()
    ref = ref_engine.generate(prompts, sps)
    ref_s = time.perf_counter() - t0
    dref = ref_engine.generate(dprompts, dsps) if dprompts else []
    ref_engine.shutdown()
    del ref_engine
    _free()
    result = {"role": "controller", "rank": grank,
              "ref": [{"tokens": r.output_token_ids,
                       "finish_reason": r.finish_reason} for r in ref],
              "disagg_ref": [{"tokens": r.output_token_ids,
                              "finish_reason": r.finish_reason}
                             for r in dref],
              "ref_boot": ref_boot, "ref_serve_s": ref_s}

    sfleet = _fleet(cfg)
    monitor = sfleet.monitor
    streams = {}
    t0 = time.perf_counter()
    rids = []
    for p, sp in zip(prompts, sps):
        rec, stream = _collector()
        deadline = time.monotonic() + 30.0
        while True:
            try:
                rid = sfleet.router.add_request(p, sp, stream=stream)
                break
            except AdmissionRejected:
                if time.monotonic() > deadline:
                    raise
                sfleet.step()      # a productive backpressure wait
        rids.append(rid)
        streams[rid] = rec

    budget = float(cfg.get("serve_budget_s", 120.0))
    while sfleet.router.has_unfinished():
        if time.perf_counter() - t0 > budget:
            break                  # report the partial state, never hang
        sfleet.step()
    serve_s = time.perf_counter() - t0

    fleet_res = []
    total = 0
    for rid in rids:
        rr = sfleet.router.finished_results.pop(rid, None)
        rec = streams[rid]
        toks = (None if rr is None
                else [int(t) for t in rr.output_token_ids])
        total += len(toks or ())
        fleet_res.append({
            "rid": rid, "tokens": toks,
            "finish_reason": None if rr is None else rr.finish_reason,
            "migrations": None if rr is None else rr.migrations,
            "replica": None if rr is None else rr.replica,
            "stream_tokens": rec["tokens"], "stream_fins": rec["fins"]})
    result["fleet"] = fleet_res
    result["serve_s"] = serve_s
    result["tokens_per_s"] = total / serve_s if serve_s > 0 else None
    # which ranks each replica slot ran on, in order (faulted ones too)
    result["slot_ranks"] = {str(i): [r for j, r in sfleet._retired
                                     if j == i] + [sfleet.rank_of(i)]
                            for i in range(len(cfg["worker_ranks"]))}

    # ---- disaggregated prefill/decode across two live replicas
    live = [h for h in sfleet.router.replicas if h.alive]
    if dprompts and len(live) >= 2:
        prefill, decode = live[0].engine, live[-1].engine
        disagg = DisaggregatedEngine(prefill, decode, client=sfleet.client)
        t0 = time.perf_counter()
        dres = disagg.generate(dprompts, dsps)
        result["disagg_s"] = time.perf_counter() - t0
        result["disagg"] = [{"tokens": r.tokens,
                             "finish_reason": r.finish_reason,
                             "finished_on": r.finished_on} for r in dres]
        result["disagg_ranks"] = [prefill.rank, decode.rank]
        result["handoffs"] = disagg.handoffs
        result["handoff_bytes"] = disagg.handoff_bytes
        result["exports"] = disagg.exports

    audits = {}
    for h in live:
        try:
            audits[str(h.engine.rank)] = h.engine.call("audit")
        except Exception as e:            # an audit must not mask results
            audits[str(h.engine.rank)] = {"error": str(e)}
    result["audits"] = audits
    # the tokens each migrated request brought to its adopter
    index = {tuple(p): i for i, p in enumerate(prompts)}
    result["adopted"] = {str(r): [[index.get(tuple(p)), n]
                                  for p, n in proxy.adopted]
                         for r, proxy in sorted(sfleet.proxies.items())}
    result["detections"] = sfleet.detections()
    cfgf = flt.get_config()
    result["dead_after_s"] = cfgf.dead_after_s
    result["verdicts"] = {
        str(r): {"since_last_beat_s": monitor.dead_at(r)
                 - monitor.last_seq_at(r)}
        for r in monitor.dead_ranks()}
    result["telemetry"] = {str(r): monitor.telemetry(r)
                           for r in cfg["worker_ranks"]
                           + list(cfg.get("spare_ranks", ()))}
    result["respawn_ms"] = sfleet.respawn_ms
    result["boots"] = [dict(h.boot_info or {})
                       for h in sfleet.router.replicas]
    snap = sfleet.router.snapshot()
    result["snapshot"] = {k: snap.get(k)
                          for k in ("failovers", "respawns", "adoptions",
                                    "spillovers")}
    result["snapshot"]["requests_finished"] = snap["requests"]["finished"]
    result["assigned"] = {str(i): sfleet.rank_of(i)
                          for i in range(len(cfg["worker_ranks"]))}
    result["postmortems"] = {
        str(r): {"in_flight_requests": pm["in_flight_requests"],
                 "in_flight_traces": pm["in_flight_traces"],
                 "spans_total": pm["spans_total"],
                 "path": pm.get("path")}
        for r, pm in sorted(sfleet.postmortems.items())}
    result.update(_peak_bytes(_device(cfg)))
    sfleet.shutdown()
    _write_result(cfg["out_dir"], "controller.json", result)


def main():
    cfg = _load_cfg()
    from paddle_tpu_torch.observability import fleettrace
    from paddle_tpu_torch.resilience import fleet as flt
    grank = flt.world().global_rank
    # spools align to the controller's clock through the store
    fleettrace.arm_from_env(rank=grank, client=flt.get_client())
    if grank == int(cfg.get("controller_rank", 0)):
        if cfg.get("traffic"):
            run_traffic_controller(cfg, grank)
        else:
            run_controller(cfg, grank)
        fleettrace.disarm()
        # bounded linger: dead-by-design peers never check out
        flt.finalize(timeout_s=float(cfg.get("finalize_s", 6.0)))
    else:
        run_replica(cfg, grank)
        fleettrace.disarm()
        flt.finalize()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
