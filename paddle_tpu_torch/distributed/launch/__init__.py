"""Multi-process launcher (counterpart of
``paddle_tpu/distributed/launch/__init__.py``)::

    python -m paddle_tpu_torch.distributed.launch \\
        --master 127.0.0.1:29400 --nnodes 4 --rank 0 script.py args...

One process per rank; each is started by the caller (a shell, a job
scheduler, a test) as a fresh interpreter. Rank 0 hosts the
coordination store (a ``torch.distributed.TCPStore`` on the master's
port); every rank connects, then waits for all N ranks to join under
the rendezvous deadline. The launcher installs the store client as the
fleet's coordination client, pins ``fleet.world()`` to
``WorldView(range(N), rank, launch_id=...)``, registers
``fleet.finalize`` at exit and runs the script as ``__main__``. It makes
no ``torch.distributed`` process group: processes that serve share only
the store.

Env fallbacks: ``PADDLE_MASTER``, ``PADDLE_NNODES``,
``PADDLE_TRAINER_ID``, ``PADDLE_LAUNCH_ID`` (the key namespace's run
id; else rank 0 draws one and publishes it through the store).
Rendezvous budget: ``PTPU_RENDEZVOUS_TIMEOUT_S`` (each attempt, default
120) and ``PTPU_RENDEZVOUS_ATTEMPTS`` (default 3); a fleet that never
forms raises :class:`~paddle_tpu_torch.resilience.fleet.
CollectiveTimeout`, and attempts that fail fast (a bad address, a port
in use) raise RuntimeError: a configuration error is not a timeout.
"""
from __future__ import annotations

import argparse
import atexit
import datetime
import os
import random
import runpy
import sys
import time

from paddle_tpu_torch.distributed.launch.store import StoreKVClient

__all__ = ["StoreKVClient", "launch", "main"]

_server = [None]        # rank 0's TCPStore: it must outlive the script


def _from_env(args):
    if args.master is None:
        args.master = os.environ.get("PADDLE_MASTER")
    if args.nnodes is None:
        v = os.environ.get("PADDLE_NNODES")
        args.nnodes = int(v) if v else None
    if args.rank is None:
        v = os.environ.get("PADDLE_TRAINER_ID")
        args.rank = int(v) if v else None
    return args


def _join_key(rank):
    return f"ptpu/launch/join/{int(rank)}"


def _connect(host, port, nnodes, rank, timeout_s):
    from torch.distributed import TCPStore
    return TCPStore(host, int(port), int(nnodes), rank == 0,
                    timeout=datetime.timedelta(seconds=timeout_s),
                    wait_for_workers=False)


def _rendezvous(master, nnodes, rank):
    """Connect to (rank 0: host) the store and wait for every rank's
    join marker, under the reference's deadline and seeded-backoff
    retry. Returns the store."""
    from paddle_tpu_torch.resilience.fleet import (CollectiveTimeout,
                                                   _env_float)
    from paddle_tpu_torch.resilience.retry import (RetryPolicy,
                                                   compute_backoff)
    host, _, port = str(master).rpartition(":")
    timeout_s = _env_float("PTPU_RENDEZVOUS_TIMEOUT_S", 120.0)
    attempts = int(_env_float("PTPU_RENDEZVOUS_ATTEMPTS", 3))
    policy = RetryPolicy(max_attempts=max(1, attempts), backoff=0.5,
                         multiplier=2.0, max_backoff=10.0, jitter=0.5)
    rng = random.Random(rank or 0)
    t0 = time.monotonic()
    last = None
    for attempt in range(policy.max_attempts):
        try:
            store = _connect(host or "127.0.0.1", port, nnodes, rank,
                             timeout_s)
            store.set(_join_key(rank), b"1")
            store.wait([_join_key(r) for r in range(nnodes)],
                       datetime.timedelta(seconds=timeout_s))
            return store
        except Exception as e:
            last = e
            if attempt + 1 < policy.max_attempts:
                time.sleep(compute_backoff(policy, attempt, rng))
    waited = time.monotonic() - t0
    if waited < 0.5 * timeout_s:
        raise RuntimeError(
            f"launch rendezvous to {master!r} failed "
            f"{policy.max_attempts}x in {waited:.1f}s (well under the "
            f"{timeout_s:.0f}s budget): a configuration error, not a "
            f"timeout") from last
    raise CollectiveTimeout(
        "launch.rendezvous", key=master, waited_s=waited,
        timeout_s=timeout_s * policy.max_attempts) from last


def launch(master=None, nnodes=None, rank=None, watchdog_timeout=None):
    """Join the fleet; returns ``(rank, nnodes)``. Without a master (or
    with one node) this is a world of one and touches nothing."""
    from paddle_tpu_torch.resilience import fleet
    if master is not None and (nnodes is None or nnodes < 2):
        raise ValueError(
            f"--master {master} given but nnodes={nnodes}: a multi-process "
            "launch needs --nnodes >= 2 (or PADDLE_NNODES)")
    if master is not None:
        if rank is None or not 0 <= int(rank) < int(nnodes):
            raise ValueError(f"--rank {rank} outside 0..{nnodes - 1}")
        rank, nnodes = int(rank), int(nnodes)
        store = _rendezvous(master, nnodes, rank)
        if rank == 0:
            _server[0] = store
        client = fleet.install_client(StoreKVClient(store))
        fleet._set_world(fleet.WorldView(range(nnodes), rank))
        lid = fleet._ensure_launch_id(client)
        fleet._set_world(fleet.WorldView(range(nnodes), rank,
                                         launch_id=lid))
        atexit.register(fleet.finalize)
    else:
        rank, nnodes = 0, 1
    if watchdog_timeout:
        from paddle_tpu_torch.distributed import elastic
        launch._elastic = elastic.install_manager(
            elastic.ElasticManager(timeout=watchdog_timeout))
    return rank, nnodes


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch",
                                allow_abbrev=False)
    p.add_argument("--master", default=None,
                   help="host:port of the store (rank 0 hosts it)")
    p.add_argument("--nnodes", type=str, default=None,
                   help="process count N (or N:M, the first taken)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--watchdog-timeout", type=float, default=None)
    p.add_argument("training_script", nargs="?", default=None)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_known_args(argv)


def main(argv=None):
    args, unknown = parse_args(argv)
    if unknown:
        raise SystemExit(f"unknown launch arguments: {unknown}")
    if args.training_script is None:
        raise SystemExit("missing training script")
    if args.nnodes is not None and ":" in str(args.nnodes):
        args.nnodes = str(args.nnodes).split(":")[0]
    args.nnodes = int(args.nnodes) if args.nnodes else None
    args = _from_env(args)
    launch(args.master, args.nnodes, args.rank, args.watchdog_timeout)
    sys.argv = [args.training_script] + list(args.training_script_args)
    runpy.run_path(args.training_script, run_name="__main__")


if __name__ == "__main__":
    main()
