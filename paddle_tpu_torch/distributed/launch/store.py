"""The coordination store: the reference's coordination-service
key-value surface over ``torch.distributed.TCPStore``.

:class:`StoreKVClient` has :class:`~paddle_tpu_torch.resilience.fleet.
LocalKVClient`'s methods and semantics:

- ``key_value_set(key, str, allow_overwrite=)`` and
  ``key_value_set_bytes``; without ``allow_overwrite`` an existing key
  raises ValueError;
- ``blocking_key_value_get(_bytes)(key, timeout_in_ms)`` waits
  server-side and raises TimeoutError on its own deadline;
- ``key_value_dir_get(_bytes)(prefix)``: sorted ``(key, value)`` pairs
  of every key that starts with ``prefix``;
- ``key_value_delete(key)`` deletes ``key`` and every ``key/...`` below
  it, so ``coord_shutdown`` reaps a whole namespace.

TCPStore has no directories; ``TCPStore.list_keys`` (torch 2.11 and
later) lists every key, and the fleet's consumers delete what they read,
so the listing stays short. Each stored value carries a one-byte tag
(``b`` bytes, ``s`` text, ``c`` a chunk manifest): the store's server
refuses a message over 8 MiB, so a value over :data:`CHUNK_BYTES` (a
page handoff of a long request is ~180 MB) is written as chunks under
``<key>#chunk<i>`` first and its manifest under ``<key>`` last, and a
reader that sees the key reads the chunks back. A TCPStore client
serialises its operations, so every thread gets its own connection
(``TCPStore.clone()``): a heartbeat thread never waits behind another
thread's blocking get.
"""
from __future__ import annotations

import datetime
import json
import threading

__all__ = ["CHUNK_BYTES", "StoreKVClient"]

CHUNK_BYTES = 4 << 20
_CHUNK = "#chunk"
# a get after its key's wait, a set, a listing: none waits on a peer
_OP_TIMEOUT = datetime.timedelta(seconds=60)


class StoreKVClient:
    """A coordination client over ``store`` (a ``TCPStore``, the
    server's own or a client connection)."""

    def __init__(self, store):
        self._store = store
        self._local = threading.local()

    def _s(self):
        s = getattr(self._local, "store", None)
        if s is None:
            s = self._store.clone()
            s.set_timeout(_OP_TIMEOUT)
            self._local.store = s
        return s

    # ------------------------------------------------------------ set
    def _set(self, key, tag, data, allow_overwrite):
        s = self._s()
        if not allow_overwrite and s.check([key]):
            raise ValueError(f"key {key!r} already set")
        if len(data) <= CHUNK_BYTES:
            s.set(key, tag + data)
            return
        n = 0
        for i in range(0, len(data), CHUNK_BYTES):
            s.set(f"{key}{_CHUNK}{n}", data[i:i + CHUNK_BYTES])
            n += 1
        s.set(key, b"c" + json.dumps({"tag": tag.decode(), "n": n,
                                      "bytes": len(data)}).encode())

    def key_value_set(self, key, value, allow_overwrite=False):
        self._set(key, b"s", str(value).encode(), allow_overwrite)

    def key_value_set_bytes(self, key, value, allow_overwrite=False):
        self._set(key, b"b", bytes(value), allow_overwrite)

    # ------------------------------------------------------------ get
    def _read(self, s, key, raw):
        """``(tag, payload)`` of the stored ``raw`` value of ``key``."""
        tag, body = raw[:1], bytes(raw[1:])
        if tag != b"c":
            return tag, body
        head = json.loads(body.decode())
        parts = [s.get(f"{key}{_CHUNK}{i}") for i in range(head["n"])]
        data = b"".join(bytes(p) for p in parts)
        if len(data) != head["bytes"]:
            raise RuntimeError(f"chunked value {key!r}: {len(data)} of "
                               f"{head['bytes']} bytes")
        return head["tag"].encode(), data

    def _blocking_get(self, key, timeout_in_ms):
        s = self._s()
        try:
            s.wait([key], datetime.timedelta(milliseconds=timeout_in_ms))
        except Exception as e:
            raise TimeoutError(
                f"DEADLINE_EXCEEDED waiting for {key!r}") from e
        return self._read(s, key, s.get(key))

    def blocking_key_value_get(self, key, timeout_in_ms):
        return self._blocking_get(key, timeout_in_ms)[1].decode()

    def blocking_key_value_get_bytes(self, key, timeout_in_ms):
        return self._blocking_get(key, timeout_in_ms)[1]

    # ----------------------------------------------------- directories
    def _keys(self, prefix):
        return sorted(k for k in self._s().list_keys()
                      if k.startswith(prefix) and _CHUNK not in k)

    def key_value_dir_get_bytes(self, prefix):
        s = self._s()
        out = []
        for k in self._keys(prefix):
            if s.check([k]):          # else deleted since the listing
                out.append((k, self._read(s, k, s.get(k))[1]))
        return out

    def key_value_dir_get(self, prefix):
        return [(k, v.decode()) for k, v in
                self.key_value_dir_get_bytes(prefix)]

    def key_value_delete(self, key):
        s = self._s()
        base = key.rstrip("/")
        for k in s.list_keys():
            if k == key or k.startswith(base + "/") \
                    or k.startswith(key + _CHUNK):
                s.delete_key(k)
