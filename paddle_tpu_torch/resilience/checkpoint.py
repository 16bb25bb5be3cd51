"""Crash-safe manifested checkpointing (counterpart of
``paddle_tpu/resilience/checkpoint.py``).

Layout of a checkpoint directory::

    run/
      MANIFEST.json            # atomic, rewritten on every save
      ckpt-00000010.pkl        # atomic write-then-rename payloads
      ckpt-00000020.pkl

The manifest is the source of truth: every entry records step, file,
byte size and a sha256 digest of the payload. ``load()`` verifies the
digest before unpickling; a torn or corrupted payload is skipped (a
recovery is noted) and the next-older good one restores instead.
Payloads and the manifest both go through
:func:`paddle_tpu_torch.framework.io.write_atomic`, the manifest only
after its payload is in place.

Payloads hold numpy copies of the state (tensors are copied to the host
when ``save`` is called), so a file pins no device and restores onto
whatever device the model lives on. ``async_save=True`` moves the disk
write and the manifest update to one background writer thread.

The ``resilience.checkpoint.save`` / ``.load`` spans and the
``resilience_checkpoint_writes_total`` / ``_corrupt_total`` counters
(:mod:`paddle_tpu_torch.observability`) make checkpoint health visible
in the same telemetry stream as everything else.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import queue
import threading
import time

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_state_dict, to_numpy,
                                           write_atomic)

__all__ = ["CheckpointCorruption", "Checkpointer", "auto_resume",
           "digest_bytes", "read_manifest", "write_manifest"]

_MANIFEST = "MANIFEST.json"
_FORMAT = 1


class CheckpointCorruption(RuntimeError):
    """Raised by ``load(strict=True)`` when every manifest entry fails
    its digest check."""


def digest_bytes(data):
    """sha256 hex digest of a payload."""
    return hashlib.sha256(data).hexdigest()


def read_manifest(directory, fmt=_FORMAT):
    """Parse ``<directory>/MANIFEST.json``; unreadable or absent gives
    an empty manifest (a cold start is not an error)."""
    try:
        with open(os.path.join(directory, _MANIFEST)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {"format": fmt, "checkpoints": []}


def write_manifest(directory, manifest):
    """Atomic manifest rewrite (fault site ``io.manifest``). Callers hold
    their checkpointer's lock: the read-modify-write must be serialised
    or a concurrent save's entry is lost."""
    write_atomic(os.path.join(directory, _MANIFEST),
                 json.dumps(manifest, indent=1).encode(), site="io.manifest")


class Checkpointer:
    """Step-indexed crash-safe checkpoint manager.

    - ``save(step, state)``: payload write, digest, manifest update and
      pruning to the ``keep`` newest;
    - ``load(step=None)``: the newest (or exactly ``step``) good
      checkpoint as ``(step, state)``, falling back past corrupt ones;
    - ``save_train_state`` / :func:`auto_resume`: the training-loop pair.
    """

    def __init__(self, directory, keep=3, async_save=False):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)
        self.async_save = bool(async_save)
        self._lock = threading.Lock()
        self._q = None
        self._writer = None
        self._writer_error = [None]
        if self.async_save:
            self._q = queue.Queue()
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="paddle_tpu_torch-ckpt-writer")
            self._writer.start()

    # ------------------------------------------------------------ save
    def _file_for(self, step):
        return f"ckpt-{int(step):08d}.pkl"

    def save(self, step, state):
        """Checkpoint ``state`` (picklable; tensors become numpy copies)
        at ``step``. Returns the payload's path (under ``async_save`` the
        write may still be in flight)."""
        t0 = time.perf_counter()
        data = pickle.dumps(to_numpy(state), protocol=4)
        entry = {
            "step": int(step),
            "file": self._file_for(step),
            "bytes": len(data),
            "sha256": digest_bytes(data),
            "time_utc": time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                      time.gmtime()),
        }
        if self.async_save:
            self._raise_writer_error()
            self._q.put((data, entry))
        else:
            self._commit(data, entry)
        obs.registry().counter(
            "resilience_checkpoint_writes_total",
            help="checkpoint save() calls").inc()
        with obs.span("resilience.checkpoint.save", step=int(step),
                      bytes=len(data), async_save=self.async_save,
                      serialize_ms=round(
                          (time.perf_counter() - t0) * 1e3, 3)):
            pass
        return os.path.join(self.directory, entry["file"])

    def _commit(self, data, entry):
        """Write the payload, then the manifest; pruned entries leave
        the same manifest write and their payloads are deleted after,
        so the manifest never names a deleted payload."""
        with self._lock:
            write_atomic(os.path.join(self.directory, entry["file"]), data)
            ckpts = [c for c in read_manifest(self.directory)["checkpoints"]
                     if c["step"] != entry["step"]]
            ckpts.append(entry)
            ckpts.sort(key=lambda c: c["step"])
            drop, ckpts = ckpts[:-self.keep], ckpts[-self.keep:]
            write_manifest(self.directory,
                           {"format": _FORMAT, "checkpoints": ckpts})
            for c in drop:
                try:
                    os.remove(os.path.join(self.directory, c["file"]))
                except OSError:
                    pass

    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, threading.Event):   # wait() flush marker
                item.set()
                continue
            data, entry = item
            try:
                self._commit(data, entry)
            except BaseException as e:  # surfaced on the next save()/wait()
                self._writer_error[0] = e

    def _raise_writer_error(self):
        err = self._writer_error[0]
        if err is not None:
            self._writer_error[0] = None
            raise RuntimeError("async checkpoint writer failed") from err

    def wait(self):
        """Block until queued async writes are committed."""
        if self._q is not None:
            done = threading.Event()
            self._q.put(done)
            done.wait()
            self._raise_writer_error()

    def close(self):
        if self._writer is not None:
            self.wait()
            self._q.put(None)
            self._writer.join(timeout=5)
            self._writer = None

    # ------------------------------------------------------------ load
    def steps(self):
        """Manifest-recorded steps, ascending (unverified)."""
        return [c["step"] for c in read_manifest(self.directory)["checkpoints"]]

    def verify(self, entry):
        """The payload's bytes if it exists with the manifested size and
        digest, else None."""
        try:
            with open(os.path.join(self.directory, entry["file"]), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if len(data) != entry["bytes"] or digest_bytes(data) != entry["sha256"]:
            return None
        return data

    def load(self, step=None, strict=False):
        """The newest good checkpoint (or exactly ``step``) as ``(step,
        state)``; None when nothing restorable exists and not
        ``strict``. Corrupt entries are skipped, noting a recovery."""
        from paddle_tpu_torch.resilience.faultinject import note_recovery
        if self.async_save:
            self.wait()
        entries = read_manifest(self.directory)["checkpoints"]
        if step is not None:
            entries = [c for c in entries if c["step"] == int(step)]
        skipped = 0
        for entry in reversed(entries):
            data = self.verify(entry)
            if data is None:
                skipped += 1
                obs.registry().counter(
                    "resilience_checkpoint_corrupt_total",
                    help="checkpoints that failed digest verification"
                ).inc()
                continue
            if skipped:
                note_recovery("io.save", "torn_write",
                              fallback_step=entry["step"], skipped=skipped)
            with obs.span("resilience.checkpoint.load",
                          step=entry["step"], skipped=skipped):
                return entry["step"], pickle.loads(data)
        if strict and entries:
            raise CheckpointCorruption(
                f"all {len(entries)} manifest entries under "
                f"{self.directory} failed digest verification")
        return None

    # ------------------------------------------- training conveniences
    def save_train_state(self, step, model=None, optimizer=None,
                         extra=None):
        """Save the model's state (``numpy_state_dict``) and the
        optimizer's (``state_dict``) at ``step``."""
        state = {"step": int(step)}
        if model is not None:
            state["model"] = numpy_state_dict(model)
        if optimizer is not None:
            state["optimizer"] = optimizer.state_dict()
        if extra is not None:
            state["extra"] = extra
        return self.save(step, state)


def auto_resume(checkpointer, model=None, optimizer=None, step=None):
    """Restore the newest good checkpoint (exactly ``step`` when given)
    into ``model`` and ``optimizer`` in place; returns ``(start_step,
    extra)``: the step after the checkpointed one (0 on a cold start)
    and what ``save_train_state(extra=...)`` recorded."""
    got = checkpointer.load(step=step)
    if got is None:
        return 0, None
    step, state = got
    if model is not None and "model" in state:
        load_numpy_state_dict(model, state["model"])
    if optimizer is not None and "optimizer" in state:
        optimizer.set_state_dict(state["optimizer"])
    return int(state.get("step", step)) + 1, state.get("extra")
