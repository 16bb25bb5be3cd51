"""Serving-fleet wire protocol: a small ordered RPC over the
coordination store (counterpart of ``paddle_tpu/serving/fleet/wire.py``).

Every replica owns one request/response lane in the fleet namespace:

- request  ``<ns>/serve/r<rank>/req/<seq>``   controller → replica
- response ``<ns>/serve/r<rank>/rsp/<seq>``   replica → controller

``seq`` is a per-lane counter the controller owns, so the lane is
ordered, and each side deletes a key the moment it consumed it, so it is
exactly-once. Messages are JSON: ``{"m": method, "p": payload}`` (plus
``"tc"``, the caller's trace context, when one is ambient) and
``{"ok": bool, "r": result}`` or ``{"ok": false, "err": ...}``; an
``AdmissionRejected`` or ValueError raised on the replica is raised
again as itself on the controller, anything else as
:class:`RemoteReplicaError`. Bulk binary (the page handoff) never rides
the lane: it goes to ``<ns>/serve/handoff/<hid>`` as one blob
(:func:`pack_state`) and the RPC carries only the ``hid``.

The controller's wait is ``fleet.kv_get_bytes`` with ``abort_if`` wired
to the watchdog's DEAD verdict, so a wedged replica fails the pending
call within one KV slice of the verdict.

Clock discipline: arrival stamps are per-process clock readings and
never cross the wire; deadlines travel as ``age_s`` and are re-anchored
on the receiver's clock, so a ``deadline_s`` counts from the first
arrival across any number of migrations.
"""
from __future__ import annotations

import io
import json

import numpy as np
import torch

from paddle_tpu_torch.observability import spans as _spans
from paddle_tpu_torch.resilience import fleet as _fleet
from paddle_tpu_torch.serving.request import SamplingParams
from paddle_tpu_torch.serving.scheduler import AdmissionRejected

__all__ = [
    "RemoteReplicaError", "req_key", "rsp_key", "handoff_key",
    "sp_to_dict", "sp_from_dict", "post_request", "await_response",
    "read_request", "post_response", "pack_state", "unpack_state",
]

RPC_SITE = "serving.fleet.rpc"


class RemoteReplicaError(RuntimeError):
    """A replica-side exception with no typed equivalent on the
    controller (its type name is in the message)."""


def req_key(namespace, rank, seq):
    return f"{namespace}/serve/r{int(rank)}/req/{int(seq)}"


def rsp_key(namespace, rank, seq):
    return f"{namespace}/serve/r{int(rank)}/rsp/{int(seq)}"


def handoff_key(namespace, hid):
    return f"{namespace}/serve/handoff/{hid}"


# ------------------------------------------------------- marshalling
def sp_to_dict(sp):
    if sp is None:
        return None
    return {"max_new_tokens": sp.max_new_tokens,
            "temperature": sp.temperature,
            "top_k": sp.top_k, "top_p": sp.top_p, "seed": sp.seed,
            "eos_token_id": sp.eos_token_id,
            "deadline_s": sp.deadline_s}


def sp_from_dict(d):
    if d is None:
        return None
    return SamplingParams(**d)


def _marshal_error(exc):
    err = {"type": type(exc).__name__, "msg": str(exc)}
    if isinstance(exc, AdmissionRejected):
        err["reason"] = exc.reason
    return err


def _unmarshal_error(err):
    t = err.get("type")
    if t == "AdmissionRejected":
        raise AdmissionRejected(err.get("reason", "remote"),
                                err.get("msg", ""))
    if t == "ValueError":
        raise ValueError(err.get("msg", ""))
    raise RemoteReplicaError(f"{t}: {err.get('msg', '')}")


# ------------------------------------------------- controller side
def post_request(client, namespace, rank, seq, method, payload, ctx=None):
    """Post one RPC; the ambient (or given) trace context rides the
    envelope as ``"tc"``."""
    if ctx is None:
        ctx = _spans.current_context()
    msg = {"m": str(method), "p": payload}
    if ctx is not None:
        msg["tc"] = ctx.to_dict()
    _fleet.kv_set_bytes(client, req_key(namespace, rank, seq),
                        json.dumps(msg).encode())


def await_response(client, namespace, rank, seq, timeout_s, *,
                   abort_if=None, config=None):
    """Block for the response to ``seq`` and consume it; returns the
    result, or raises ``CollectiveTimeout`` or the remote exception."""
    key = rsp_key(namespace, rank, seq)
    raw = _fleet.kv_get_bytes(client, key, timeout_s, site=RPC_SITE,
                              missing_rank=int(rank), abort_if=abort_if,
                              config=config)
    try:
        client.key_value_delete(key)
    except Exception:
        pass            # the namespace reap at finalize() catches it
    rsp = json.loads(bytes(raw).decode())
    if not rsp.get("ok"):
        _unmarshal_error(rsp.get("err", {}))
    return rsp.get("r")


# ---------------------------------------------------- replica side
def read_request(client, namespace, rank, seq, timeout_s, *, config=None):
    """Replica-side read of request ``seq`` (short, so the serve loop
    can interleave beats and stop checks); returns ``(method, payload,
    trace context or None)``, raises ``CollectiveTimeout`` on an empty
    window."""
    key = req_key(namespace, rank, seq)
    raw = _fleet.kv_get_bytes(client, key, timeout_s,
                              site="serving.fleet.recv", config=config)
    try:
        client.key_value_delete(key)
    except Exception:
        pass
    msg = json.loads(bytes(raw).decode())
    return (msg["m"], msg.get("p"),
            _spans.TraceContext.from_dict(msg.get("tc")))


def post_response(client, namespace, rank, seq, result=None, error=None):
    rsp = ({"ok": False, "err": _marshal_error(error)}
           if error is not None else {"ok": True, "r": result})
    _fleet.kv_set_bytes(client, rsp_key(namespace, rank, seq),
                        json.dumps(rsp).encode())


# --------------------------------------- page-handoff serialization
def _host_array(t):
    """``(numpy array, dtype name)`` of a tensor or array; a bf16 tensor
    travels as its 16-bit patterns (numpy has no bf16 of its own)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), name
        return t.numpy(), name
    a = np.asarray(t)
    return a, a.dtype.name


def pack_state(state):
    """``LLMEngine.export_page_state`` dict → one npz blob: the JSON
    header under ``__meta__`` (with each block's dtype), the per-layer
    KV blocks as arrays. A round trip is bit-exact, bf16 included."""
    arrays = {}
    dtypes = {}
    for li, blk in enumerate(state["layers"]):
        for name, t in blk.items():
            key = f"L{li}.{name}"
            arrays[key], dtypes[key] = _host_array(t)
    meta = {k: v for k, v in state.items() if k != "layers"}
    meta["num_layers"] = len(state["layers"])
    meta["__dtypes__"] = dtypes
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_state(blob):
    """Inverse of :func:`pack_state`: the layers come back as host
    tensors of their exported dtypes."""
    with np.load(io.BytesIO(bytes(blob))) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        n = int(meta.pop("num_layers"))
        dtypes = meta.pop("__dtypes__")
        layers = []
        for li in range(n):
            prefix = f"L{li}."
            blk = {}
            for k in z.files:
                if not k.startswith(prefix):
                    continue
                t = torch.from_numpy(np.array(z[k]))
                if dtypes[k] == "bfloat16":
                    t = t.view(torch.bfloat16)
                blk[k[len(prefix):]] = t
            layers.append(blk)
    state = dict(meta)
    state["layers"] = layers
    return state
