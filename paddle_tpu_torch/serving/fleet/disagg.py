"""Disaggregated prefill/decode: page handoff between engines
(counterpart of ``paddle_tpu/serving/fleet/disagg.py``).

PREFILL engines absorb the compute-bound prompt pass and fill KV pages
(bf16 or quantized ``(codes, scales)``); DECODE engines run the
memory-bound token loop. The handoff moves the pages and the scheduler
state (tokens, sampling params, stream watermark, deadline age, arrival
index) through ``LLMEngine.export_page_state`` / ``import_page_state``,
and across processes as one ``<ns>/serve/handoff/<hid>`` blob of the
coordination store in :func:`~paddle_tpu_torch.serving.fleet.wire.
pack_state`'s format.

Token identity is the contract: the pages move, not the tokens, and the
(seed, absolute position) sampler continues on the decode engine where
the prefill engine stopped, so a disaggregated run equals the monolithic
engine's token for token; the import writes pages in place and builds
no program.

:class:`DisaggregatedEngine` takes an engine (local, or a
:class:`~paddle_tpu_torch.serving.fleet.handle.RemoteEngineClient`) for
each role; ``generate()`` admits on the prefill side, hands each request
off after its first token and drains the decode side. A decode-side
``AdmissionRejected`` leaves the exported blob retryable. ``handoffs``
and ``handoff_bytes`` count what moved; ``exports`` keeps each remote
export's reply (bytes, pages, pack and store-set ms).
"""
from __future__ import annotations

from paddle_tpu_torch.observability import span
from paddle_tpu_torch.resilience import fleet as _fleet
from paddle_tpu_torch.serving.fleet import wire
from paddle_tpu_torch.serving.scheduler import AdmissionRejected

__all__ = ["DisaggregatedEngine", "DisaggResult"]


def _is_remote(engine):
    return hasattr(engine, "call")


class DisaggResult:
    """Per-prompt outcome: where it finished (``"prefill"`` for
    single-token / early-stop requests that never needed the decode
    side, else ``"decode"``), the full token history, and the finish
    reason."""

    __slots__ = ("tokens", "finish_reason", "finished_on")

    def __init__(self, tokens, finish_reason, finished_on):
        self.tokens = [int(t) for t in tokens]
        self.finish_reason = finish_reason
        self.finished_on = finished_on


class DisaggregatedEngine:
    def __init__(self, prefill, decode, client=None, namespace_fn=None):
        self.prefill = prefill
        self.decode = decode
        self._client = client
        self._ns = namespace_fn or _fleet.coord_namespace
        self._next_hid = 0
        self.handoffs = 0
        self.handoff_bytes = 0
        self.exports = []

    # ------------------------------------------------------- transfer
    def export(self, request_id):
        """Pull `request_id` off the prefill side; returns an opaque
        retryable handle for :meth:`import_`.  Remote exports park the
        blob in the coordination KV under a fresh ``hid``; local ones
        carry the state dict (optionally bounced through the KV when a
        client is given, to exercise the real wire format)."""
        hid = f"h{self._next_hid}"
        self._next_hid += 1
        if _is_remote(self.prefill):
            r = self.prefill.call("export_handoff",
                                  {"request_id": request_id,
                                   "hid": hid})
            self.handoff_bytes += int(r.get("bytes", 0))
            self.exports.append(r)
            return ("kv", hid)
        state = self.prefill.export_page_state(request_id)
        if self._client is not None:
            blob = wire.pack_state(state)
            self.handoff_bytes += len(blob)
            _fleet.kv_set_bytes(self._client,
                                wire.handoff_key(self._ns(), hid), blob)
            return ("kv", hid)
        return ("state", state)

    def import_(self, handle, stream=None):
        """Land an exported request on the decode side; raises
        ``AdmissionRejected`` with the handle still valid (retry after
        the decode side frees a slot).  Returns the decode-side rid."""
        kind, payload = handle
        if _is_remote(self.decode):
            if kind != "kv":
                raise ValueError("a remote decode engine imports only "
                                 "KV-parked handoffs")
            rid = self.decode.call("import_handoff", {"hid": payload})
            self.decode.attach_stream(rid, stream)
        else:
            if kind == "kv":
                key = wire.handoff_key(self._ns(), payload)
                blob = _fleet.kv_get_bytes(
                    self._client, key, site="serving.fleet.handoff")
                state = wire.unpack_state(blob)
                rid = self.decode.import_page_state(state,
                                                    stream=stream)
                try:
                    self._client.key_value_delete(key)
                except Exception:
                    pass
            else:
                rid = self.decode.import_page_state(payload,
                                                    stream=stream)
        self.handoffs += 1
        with span("serving.disagg.handoff", rid=rid, kind=kind):
            pass
        return rid

    # ------------------------------------------------------- generate
    def generate(self, prompts, sampling_params=None):
        """Serve `prompts` through the split: admit on the prefill
        side, hand each request off after its FIRST token (the
        prefill-produced one), drain the decode side; returns one
        :class:`DisaggResult` per prompt in input order."""
        if prompts and isinstance(prompts[0], int):
            raise TypeError("generate expects a LIST of prompts "
                            "(each a list of token ids)")
        if isinstance(sampling_params, (list, tuple)):
            if len(sampling_params) != len(prompts):
                raise ValueError("one SamplingParams per prompt "
                                 "required")
            sps = list(sampling_params)
        else:
            sps = [sampling_params] * len(prompts)
        order = []                 # prefill rid, in input order
        for p, sp in zip(prompts, sps):
            order.append(self.prefill.add_request(
                [int(t) for t in p], sp))
        pending = set(order)       # still on the prefill side
        ready = []                 # (prefill_rid, export handle)
        mapping = {}               # decode rid -> prefill rid
        results = {}               # prefill rid -> DisaggResult
        live_decode = set()
        stall = 0
        while pending or ready or live_decode:
            progressed = False
            if pending:
                for rid, tok, fin in self.prefill.step():
                    if rid not in pending:
                        continue
                    progressed = True
                    if fin:
                        req = self.prefill.finished_requests.pop(
                            rid, None)
                        results[rid] = DisaggResult(
                            req.output_token_ids if req else (),
                            getattr(req, "finish_reason", None),
                            "prefill")
                        pending.discard(rid)
                    elif tok is not None:
                        # first token landed: the request is DECODE-
                        # state on the prefill engine — export now
                        # (frees its prefill pages) and queue the
                        # import
                        ready.append((rid, self.export(rid)))
                        pending.discard(rid)
            if ready:
                still = []
                for rid, handle in ready:
                    try:
                        drid = self.import_(handle)
                    except AdmissionRejected:
                        still.append((rid, handle))  # retry next round
                        continue
                    progressed = True
                    mapping[drid] = rid
                    live_decode.add(drid)
                ready = still
            if live_decode:
                for drid, tok, fin in self.decode.step():
                    if not fin or drid not in live_decode:
                        continue
                    progressed = True
                    req = self.decode.finished_requests.pop(drid, None)
                    rid = mapping.pop(drid)
                    results[rid] = DisaggResult(
                        req.output_token_ids if req else (),
                        getattr(req, "finish_reason", None), "decode")
                    live_decode.discard(drid)
            # a full round with no event anywhere means the split is
            # wedged (e.g. decode forever refusing imports) — fail
            # loudly rather than spin
            stall = 0 if progressed else stall + 1
            if stall > 1024:
                # reap the abandoned handoffs: nobody will import these
                # hids, and their blobs (the store's largest values)
                # would otherwise live until the namespace reap
                if self._client is not None:
                    for _rid, handle in ready:
                        kind, payload = handle
                        if kind != "kv":
                            continue
                        try:
                            self._client.key_value_delete(
                                wire.handoff_key(self._ns(), payload))
                        except Exception:
                            pass
                raise RuntimeError(
                    f"disaggregated generate stalled: {len(pending)} "
                    f"prefilling, {len(ready)} awaiting import, "
                    f"{len(live_decode)} decoding")
        return [results[rid] for rid in order]
