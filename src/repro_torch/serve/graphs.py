"""Captured serving steps: one CUDA graph over static buffers, the port's
counterpart of the reference's ``jax.jit`` of a serving step.

A :class:`StaticStep` wraps a function that reads only tensors held in
fixed buffers (its static inputs: the caller copies each call's values
into them) and returns tensors.  :meth:`StaticStep.first` runs it once for
real and makes it replayable; :meth:`StaticStep.replay` runs it again on
whatever the static inputs now hold and returns the static outputs.

* On a CUDA device ``first`` warms the function up on a side stream, as
  ``torch.cuda.graph`` asks (the first call also builds and loads the
  kernel libraries), returns that real run's outputs, and then captures
  the function once into a graph; ``replay`` replays the graph.  Both run
  with the step's device made current, whichever device the host thread
  had current.  A capture that fails raises: nothing falls back to eager.
* On the CPU nothing is captured: ``replay`` runs the function and copies
  its results into the outputs of the first run, so the static outputs
  are overwritten in place exactly as a graph's are, and the callers'
  buffer and aliasing logic runs the same on both devices.

The static outputs are overwritten by the next replay: a caller that keeps
an output past it keeps a copy.

Python's cyclic garbage collector is off during a capture.  An engine
that holds captured graphs is a reference cycle (its steps' functions
refer to it); dropped, it is freed by the collector whenever that next
runs, and a graph destroyed while another is being captured makes the
capture fail (``torch.cuda.graph`` no longer collects before it
captures).  The collector runs again after the capture.

Launch counts.  The kernel wrappers count their launches on the host
(``kernels.common.launch_c``); a capture runs that host code without
launching anything and a replay launches without running it.  So the
launches counted during the capture are taken back and recorded, and each
replay adds them again: a wrapper's ``launches`` keeps counting the
kernels that ran.
"""

from __future__ import annotations

from typing import Callable, Sequence

import gc

import torch


def copy_into(dst, src) -> None:
    """Copy a tree (tensors, ``None``, tuples, named tuples and lists of
    them: a step's results, a decode state) into the same-shaped tree
    ``dst``, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            copy_into(d, s)
    elif dst is not None or src is not None:
        raise TypeError(f"cannot copy {type(src).__name__} into "
                        f"{type(dst).__name__}")


class StaticStep:
    """One serving step over static buffers, captured once on the card.

    Args:
      fn: the step; reads only static tensors, returns a tree of tensors.
      device: where it runs; a CUDA device captures a graph.
      counted: the kernel wrappers whose ``launches`` a replay adds to.
      pool: the graph memory pool (``torch.cuda.graph_pool_handle()``)
        shared by the steps of one engine; ``None`` gives the graph its
        own.  Sharing is safe as the engine uses it: one step runs at a
        time on one stream, and each step's outputs stay referenced, so
        another capture reuses only a step's freed intermediates, which
        that step writes again before it reads them.
    """

    def __init__(self, fn: Callable, device: torch.device, *,
                 counted: Sequence = (), pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.counted = tuple(counted)
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.launches: dict = {}     # wrapper -> launches one replay makes
        self.ready = False

    def first(self):
        """Run the step for real and make it replayable (on the card: a
        warm-up on a side stream, then one capture).  Returns the real
        run's outputs, which no replay overwrites."""
        if self.ready:
            raise RuntimeError("StaticStep.first() runs once; replay() it")
        if self.device.type != "cuda":
            self.outputs = self.fn()
            self.ready = True
            return self.outputs
        # The warm-up and the capture run with the step's card current:
        # torch.cuda.graph captures on a stream of the current device.
        with torch.cuda.device(self.device):
            return self._capture()

    def _capture(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = [w.launches for w in self.counted]
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn()
        finally:
            if collecting:
                gc.enable()
            # The capture launched nothing: take its counts back.
            taken = {w: w.launches - n for w, n in zip(self.counted, before)}
            for w, n in taken.items():
                w.launches -= n
        self.graph, self.outputs, self.ready = graph, outputs, True
        self.launches = {w: n for w, n in taken.items() if n}
        return out

    def replay(self):
        """Run the step again on the static inputs; returns the static
        outputs (overwritten by the next replay)."""
        if not self.ready:
            raise RuntimeError("StaticStep.replay() before first()")
        if self.graph is None:
            copy_into(self.outputs, self.fn())
            return self.outputs
        with torch.cuda.device(self.device):
            self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n
        return self.outputs
