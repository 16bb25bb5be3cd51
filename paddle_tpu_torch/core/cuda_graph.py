"""Capture and replay of a program as a CUDA graph: the mechanics the
port's compiled programs share (the serving engine's, ``serving/
engine.py:_Graph``, and ``to_static``'s train step, ``jit/api.py``).

A graph replays fixed addresses, so a program runs over static input
buffers (:class:`StaticInputs`) that each call copies its arguments
into, CPU arguments through pinned staging so no copy waits for the
host. Before its capture a program runs eagerly on the capture stream
(:func:`warm_up`): the first call loads what it launches (the kernel
library, cuBLAS's handle and workspace) and makes what is made lazily,
so none of that happens, or is baked in, under capture. The captured
region's kernel counts (``ops/cuda/launch.py:captured_counts``) are
added once a replay. A capture that fails raises: nothing runs the
program eagerly in its place.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.cuda import launch

__all__ = ["CapturedGraph", "StaticInputs", "WARMUP_CALLS", "warm_up"]

WARMUP_CALLS = 2      # eager calls of a program before its capture


class StaticInputs:
    """A graph's input buffers: copies of ``example`` on ``device``, and
    the pinned host buffers that CPU arguments are staged through, made
    when first needed."""

    def __init__(self, example, device):
        self.buffers = [a.to(device, copy=True) for a in example]
        self._staging = [None] * len(self.buffers)
        self._staged = torch.cuda.Event()

    def load(self, args):
        """Copy ``args`` (CPU or CUDA tensors of the buffers' shapes and
        types) into the buffers, after the last call's copies are
        done."""
        self._staged.synchronize()
        for i, (buf, a) in enumerate(zip(self.buffers, args)):
            if a.is_cuda:
                buf.copy_(a)
                continue
            host = self._staging[i]
            if host is None:
                host = self._staging[i] = torch.empty(
                    a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a)
            buf.copy_(host, non_blocking=True)

    def mark(self):
        """Record, on the current stream, that this call's copies are
        enqueued: the next :meth:`load` waits for them."""
        self._staged.record()


def warm_up(fn, args, stream, calls=WARMUP_CALLS):
    """``fn(*args)`` ``calls`` times on ``stream``, ordered after the
    current stream's work and before its later work; the last call's
    result."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        for _ in range(calls):
            out = fn(*args)
    current.wait_stream(stream)
    return out


class CapturedGraph:
    """``fn(*inputs.buffers)`` captured on ``stream`` into ``pool``
    (None: a private pool). ``out`` is what the captured call returned:
    its tensors are the graph's, and each replay writes them again."""

    def __init__(self, fn, inputs, pool, stream):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        with launch.captured_counts() as self.counts:
            # the default, global capture mode also takes the kernels
            # autograd's device threads launch for a backward
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = fn(*inputs.buffers)

    def replay(self):
        """Replay on the current stream over what the buffers hold."""
        self.inputs.mark()
        self.graph.replay()
        launch.add_replay_counts(self.counts)

    def __call__(self, args):
        """Copy ``args`` into the buffers and replay; ``out``, which the
        next call overwrites."""
        self.inputs.load(args)
        self.replay()
        return self.out

    def release(self):
        self.graph.reset()
