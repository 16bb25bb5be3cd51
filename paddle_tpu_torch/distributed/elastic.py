"""Failure detection and elastic supervision (counterpart of
``paddle_tpu/distributed/elastic.py``).

- :class:`Watchdog`: a step-progress heartbeat. When no
  :meth:`~Watchdog.beat` arrives within ``timeout`` seconds it prints
  the live stacks, calls ``on_stall`` (once a stall) and, with
  ``abort``, exits with code 43 (the launcher's "restart me").
- :class:`HeartbeatServer`: multi-process liveness over the fleet's
  coordination store: every rank publishes a timestamp under
  ``<namespace>/hb/<rank>``; rank 0 flags ranks whose timestamp is
  stale. A no-op in a world of one.
- :func:`notify_progress`: the global progress hook. It beats the
  installed :class:`ElasticManager`'s watchdog and the fleet's heartbeat
  publisher (``resilience.fleet.notify_fleet_progress``), so a slow
  gradient-merge window or a long preemption save reads as progress.
- :class:`Command`: elastic scale control, the target world size ``np``
  in a JSON file of the temporary directory shared by node-local
  processes (the reference's own store; its upstream keeps it in etcd).
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import tempfile
import threading
import time

__all__ = ["Command", "ElasticManager", "HeartbeatServer", "Watchdog",
           "get_manager", "install_manager", "notify_progress"]


class Watchdog:
    """Step-progress heartbeat: call :meth:`beat` every step; if none
    arrives within ``timeout`` seconds the stall fires once a stall
    episode."""

    def __init__(self, timeout=300.0, on_stall=None, abort=False,
                 poll_interval=None):
        self.timeout = float(timeout)
        self.on_stall = on_stall
        self.abort = abort
        self._poll = poll_interval or min(self.timeout / 4, 10.0)
        self._last_beat = time.monotonic()
        self._last_step = None
        self._stalled = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle_tpu_torch-watchdog")
        self._thread.start()

    def beat(self, step=None):
        self._last_beat = time.monotonic()
        self._last_step = step
        self._stalled = False

    def _run(self):
        while not self._stop.wait(self._poll):
            idle = time.monotonic() - self._last_beat
            if idle > self.timeout and not self._stalled:
                self._stalled = True
                self._fire(idle)

    def _fire(self, idle):
        print(f"[paddle_tpu_torch.elastic] WATCHDOG: no training progress "
              f"for {idle:.0f}s (last step {self._last_step}); likely a "
              f"hung collective or wedged device", file=sys.stderr,
              flush=True)
        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            pass
        if self.on_stall is not None:
            try:
                self.on_stall(idle, self._last_step)
            except Exception:
                pass
        if self.abort:
            os._exit(43)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _hb_prefix():
    from paddle_tpu_torch.resilience import fleet
    return f"{fleet.coord_namespace()}/hb"


class HeartbeatServer:
    """Multi-process liveness over the fleet's coordination store: every
    rank publishes ``time.time()`` every ``interval`` seconds; rank 0
    calls ``on_dead(ranks)`` with the ranks whose beat is older than
    ``stale_after`` (a rank with no beat yet only after that grace from
    start). Keys live under the run's namespace and :meth:`stop` reaps
    this rank's own."""

    def __init__(self, interval=30.0, stale_after=120.0, on_dead=None,
                 client=None, world_view=None):
        from paddle_tpu_torch.resilience import fleet
        self.interval = interval
        self.stale_after = stale_after
        self.on_dead = on_dead
        self._client = client if client is not None else fleet.get_client()
        self._world = world_view or fleet.world()
        self._stop = threading.Event()
        self._start_time = time.time()
        self._pid = None
        self._thread = None
        if self._client is not None and self._world.size > 1:
            self._pid = self._world.global_rank
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def poll_once(self):
        """One publish (and, on rank 0, one staleness check); returns
        the stale ranks rank 0 found."""
        prefix = _hb_prefix()
        self._client.key_value_set(f"{prefix}/{self._pid}",
                                   str(time.time()), allow_overwrite=True)
        if self._pid != self._world.members[0]:
            return []
        latest = {}
        for k, v in self._client.key_value_dir_get(f"{prefix}/"):
            r = int(k.rsplit("/", 1)[-1])
            latest[r] = max(latest.get(r, 0.0), float(v))
        cutoff = time.time() - self.stale_after
        grace_over = time.time() - self._start_time > self.stale_after
        dead = [r for r in self._world.members
                if (latest[r] < cutoff if r in latest else grace_over)]
        if dead and self.on_dead is not None:
            self.on_dead(dead)
        return dead

    def _run(self):
        failures = 0
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
                failures = 0
            except Exception as e:
                failures += 1
                if failures <= 3 or failures % 20 == 0:
                    print(f"[paddle_tpu_torch.elastic] heartbeat poll "
                          f"failed ({failures}x): {type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)
                if failures >= 60:
                    print("[paddle_tpu_torch.elastic] heartbeat DISABLED "
                          "after 60 consecutive failures", file=sys.stderr,
                          flush=True)
                    return

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._client is not None and self._pid is not None:
            try:
                self._client.key_value_delete(f"{_hb_prefix()}/{self._pid}")
            except Exception:
                pass


class ElasticManager:
    """The step watchdog with host heartbeats and, optionally, a
    :class:`~paddle_tpu_torch.resilience.preemption.PreemptionHandler`
    installed with its signal handlers (its drain beats this manager's
    watchdog around the final save)."""

    def __init__(self, timeout=300.0, abort_on_stall=True,
                 preemption=None):
        self.watchdog = Watchdog(timeout=timeout, abort=abort_on_stall)
        self.heartbeats = HeartbeatServer()
        self.preemption = preemption
        if preemption is not None:
            from paddle_tpu_torch.resilience import preemption as _pre
            _pre.install(preemption)
            preemption.install_signal_handlers()

    def beat(self, step=None):
        self.watchdog.beat(step)

    def stop(self):
        self.watchdog.stop()
        self.heartbeats.stop()
        if self.preemption is not None:
            from paddle_tpu_torch.resilience import preemption as _pre
            self.preemption.uninstall_signal_handlers()
            _pre.uninstall(self.preemption)


_active_manager = None
_step_counter = [0]


def install_manager(manager):
    global _active_manager
    _active_manager = manager
    return manager


def get_manager():
    return _active_manager


def notify_progress():
    """Beat the installed manager's watchdog and the fleet's heartbeat
    publisher (each a no-op when none is installed)."""
    if _active_manager is not None:
        _step_counter[0] += 1
        _active_manager.beat(_step_counter[0])
    from paddle_tpu_torch.resilience import fleet
    fleet.notify_fleet_progress()



class Command:
    """Elastic scale control: ``np``, the target world size, in
    ``<tmpdir>/ptpu_elastic_<name>.json`` (the reference's file, so the
    two packages' processes on one node share it). ``server`` is
    accepted and unused, as in the reference."""

    def __init__(self, server=None, name="default"):
        self.path = os.path.join(tempfile.gettempdir(),
                                 f"ptpu_elastic_{name}.json")

    def _read(self):
        try:
            with open(self.path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {}

    def set_np(self, np):
        state = self._read()
        state["np"] = int(np)
        with open(self.path, "w") as fh:
            json.dump(state, fh)

    def scale_np(self, np):
        """Set ``np`` only when a target was set before; True if so."""
        if self._read().get("np") is not None:
            self.set_np(np)
            return True
        return False

    def clean(self):
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
