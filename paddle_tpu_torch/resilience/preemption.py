"""Preemption: drain, checkpoint, exit — instead of dying mid-step
(counterpart of ``paddle_tpu/resilience/preemption.py``).

Hosts get evicted (spot/preemptible VMs, maintenance events) with a
signal and a short grace window. The handler turns that into a
cooperative protocol:

1. the signal (default SIGTERM) only sets a flag: signal context does
   no real work;
2. the training loop polls :meth:`PreemptionHandler.check` once per
   step; at the first step boundary after the signal it drains: saves a
   final checkpoint, waits for the checkpointer's queued writes, and
   (optionally) exits with a distinct code the launcher maps to
   "restart me".

The drain beats the elastic watchdog (``distributed/elastic.py``)
around the save, so that a slow final save is not taken for a stall.

The fault-injection kind ``preempt`` calls :func:`request_preemption`
on the installed handler, so chaos plans exercise exactly the
production path minus the actual signal delivery. Every drain bumps
``resilience_preemptions_total`` and records a
``resilience.preempt.drain`` span.
"""
from __future__ import annotations

import os
import signal as _signal
import sys
import threading
import time

from paddle_tpu_torch import observability as obs

__all__ = ["PreemptionHandler", "request_preemption", "install",
           "get_handler", "uninstall"]

_active_handler = None
_lock = threading.Lock()


def install(handler):
    """Make `handler` the process-wide preemption target (what the
    ``preempt`` fault kind and external callers hit)."""
    global _active_handler
    with _lock:
        _active_handler = handler
    return handler


def get_handler():
    return _active_handler


def uninstall(handler=None):
    """Clear the process-wide handler (only if it is `handler`, when
    given), as :class:`PreemptionHandler.__exit__` does, so a stopped
    loop's handler cannot swallow later preemption requests."""
    global _active_handler
    with _lock:
        if handler is not None and _active_handler is not handler:
            return
        _active_handler = None


def request_preemption(reason="external"):
    """Flag the installed handler (no-op without one, so fault plans
    with ``preempt`` faults are harmless in loops that opted out)."""
    h = _active_handler
    if h is not None:
        h.request(reason)
    return h is not None


class PreemptionHandler:
    """Cooperative drain-and-checkpoint on preemption.

    Usage::

        ckpt = Checkpointer("run/ckpt", async_save=True)
        with PreemptionHandler(checkpointer=ckpt) as pre:
            start, _ = auto_resume(ckpt, model, opt)
            for step in range(start, steps):
                train_step(...)
                if pre.check(step, lambda: {
                        "step": step, "model": numpy_state_dict(model),
                        "optimizer": opt.state_dict()}):
                    break                    # drained + checkpointed

    `exit_code` non-None additionally ``os._exit``\\ s after the drain
    (the launcher restarts the job; the reference uses 44). Tests and
    library code leave it None and observe the bool.
    """

    def __init__(self, checkpointer=None, signals=None,
                 exit_code=None, auto_install=True):
        self.checkpointer = checkpointer
        self.exit_code = exit_code
        self._flag = threading.Event()
        self.reason = None
        self.drained = False
        self.drain_step = None
        self.drain_ms = None
        self._notice_pending = False
        self._notice_lock = threading.Lock()
        self._prev = {}
        self._signals = tuple(signals) if signals is not None \
            else (_signal.SIGTERM,)
        if auto_install:
            install(self)

    # ---- signal / request plumbing ----
    def install_signal_handlers(self):
        """Bind the OS signals (main thread only — callers running in
        worker threads use :func:`request_preemption` instead)."""
        for sig in self._signals:
            self._prev[sig] = _signal.signal(sig, self._on_signal)
        return self

    def uninstall_signal_handlers(self):
        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame):
        # Signal context does NOTHING but set the flag.  A Python
        # signal handler runs between bytecodes of whatever the main
        # thread was doing — buffered-stderr writes there can deadlock
        # on the io lock the interrupted code may hold, so the operator
        # notice is deferred to the next check() poll.
        if not self._flag.is_set():
            self.reason = f"signal:{_signal.Signals(signum).name}"
            self._notice_pending = True
            self._flag.set()

    def request(self, reason="external"):
        if not self._flag.is_set():
            # same publish order as _on_signal: reason and the pending
            # notice must be visible BEFORE the flag — a concurrently
            # polling check() may drain (and exit) the moment the flag
            # is up, and must find the notice to flush
            self.reason = reason
            self._notice_pending = True
            self._flag.set()
            self._flush_notice()

    def _flush_notice(self):
        """Emit the queued operator notice exactly once (called from
        ordinary thread context only, never from the signal handler —
        which is why the handler sets the flag lock-free while this
        side test-and-clears under a lock)."""
        with self._notice_lock:
            pending, self._notice_pending = self._notice_pending, False
        if pending:
            print(f"[paddle_tpu_torch.resilience] preemption requested "
                  f"({self.reason}); will drain at the next step "
                  f"boundary", file=sys.stderr, flush=True)

    @property
    def preempted(self):
        return self._flag.is_set()

    # ---- the step-boundary poll ----
    def check(self, step, state_fn=None):
        """Call once per training step.  Returns False on the hot path;
        on a pending preemption it drains (checkpoint via `state_fn` or
        the checkpointer's queued writes), records telemetry, optionally
        exits, and returns True — the loop should break."""
        if not self._flag.is_set():
            return False
        self._flush_notice()    # notice deferred from signal context
        self.drain(step, state_fn)
        if self.exit_code is not None:
            os._exit(self.exit_code)
        return True

    def drain(self, step, state_fn=None):
        """Save ``state_fn()`` at ``step`` (with a checkpointer and a
        state), wait for the checkpointer's queued writes, and record
        the drain."""
        from paddle_tpu_torch.distributed import elastic
        t0 = time.perf_counter()
        # heartbeat around the save: a drain is progress, not a stall
        elastic.notify_progress()
        if self.checkpointer is not None and state_fn is not None:
            self.checkpointer.save(step, state_fn())
        if self.checkpointer is not None:
            self.checkpointer.wait()
        elastic.notify_progress()
        self.drained = True
        self.drain_step = step
        self.drain_ms = round((time.perf_counter() - t0) * 1e3, 3)
        obs.registry().counter(
            "resilience_preemptions_total",
            help="preemption drains completed").inc()
        with obs.span("resilience.preempt.drain", step=step,
                      reason=self.reason or "", drain_ms=self.drain_ms):
            pass

    def reset(self):
        """Re-arm after a handled preemption (tests, multi-run loops)."""
        self._flag.clear()
        self.reason = None
        self.drained = False
        self.drain_step = None
        self.drain_ms = None
        self._notice_pending = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uninstall_signal_handlers()
        uninstall(self)
        return False
