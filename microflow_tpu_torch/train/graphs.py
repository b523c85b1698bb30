"""A train step's phases as CUDA graphs (``TrainableModel`` on CUDA).

A step runs a couple of thousand small torch operations and kernel
launches; launched one by one from Python, they leave the host pacing
the card.  So
``TrainableModel`` captures each phase of the step once, as a CUDA graph,
and replays it: the forward with the dequantize of the loss output, the
backward with the plain-sum fold, and the update.

A graph reads and writes fixed addresses, so the state of the step lives
in static buffers (``StaticTrees``: the params and the accumulators; each
forward and backward graph has its own input and label buffers), and the
constants it reads are the resident ones of ``core.numerics``.  The keys
(``step_key``, ``update_key``) are what the code can observe; where a key
is None the step runs the eager code.
"""

from __future__ import annotations

import numbers
import warnings
from collections import Counter

import torch

from ..core import numerics
from ..utils import trace
from . import optimizer

# what a key maps to before its graph exists: seen once (the eager
# warm-up ran), or its capture failed (eager from then on)
WARM = "warm"
FAILED = "failed"


def step_key(device: torch.device, xq: torch.Tensor, gt_q: torch.Tensor, gradient_mode: str,
             bound: int | None):
    """The key of a step's forward and backward graphs, or None where the
    step runs eager: off CUDA, an empty batch, a fold bound that had to be
    read from the device (``bound`` None), or a fold that may saturate
    (the serial fold)."""
    batch = xq.shape[0]
    if (device.type != "cuda" or batch == 0 or bound is None
            or not optimizer.fold_is_plain_sum(bound, batch)):
        return None
    return tuple(xq.shape), xq.dtype, tuple(gt_q.shape), gt_q.dtype, gradient_mode


def update_key(device: torch.device, batch_size, lr):
    """The key of an update's graph, or None where it runs eager: off CUDA,
    or a batch size or learning rate that is not a plain number."""
    if (device.type != "cuda" or not isinstance(batch_size, numbers.Integral)
            or not isinstance(lr, numbers.Real)):
        return None
    return int(batch_size), float(lr)


def copy_tree(static: dict, new: dict) -> None:
    """Write each leaf of ``new`` into ``static``'s, where it is another
    tensor."""
    for key, sub in new.items():
        for name, value in sub.items():
            target = static[key][name]
            if value is not target:
                target.copy_(value)


class StaticTrees:
    """The params and the accumulators that the graphs read and write
    (``trees["params"]``, ``trees["grads"]``), and the model's own leaves
    as they were when they last agreed with them (tensor and version)."""

    def __init__(self):
        self.trees: dict[str, dict] = {}
        self._seen: dict[str, dict] = {}

    def _agree(self, name: str, held: dict) -> None:
        self._seen[name] = {(k, n): (v, v._version) for k, sub in held.items()
                            for n, v in sub.items()}

    def sync(self, name: str, held: dict) -> bool:
        """Make the static tree ``name`` equal to ``held`` (made from it the
        first time), copying the leaves that are other tensors, or were
        written to, since they last agreed.  False, and nothing copied,
        where ``held`` has other layers, leaves, shapes or dtypes."""
        static = self.trees.get(name)
        if static is None:
            self.trees[name] = {k: {n: v.clone() for n, v in sub.items()}
                                for k, sub in held.items()}
            self._agree(name, held)
            return True
        seen = self._seen[name]
        if held.keys() != static.keys():
            return False
        changed = []
        for key, sub in static.items():
            held_sub = held[key]
            if held_sub.keys() != sub.keys():
                return False
            for leaf, target in sub.items():
                value = held_sub[leaf]
                was = seen.get((key, leaf))
                if was is not None and was[0] is value and was[1] == value._version:
                    continue
                if (value.shape != target.shape or value.dtype != target.dtype
                        or value.device != target.device):
                    return False
                changed.append((key, leaf, target, value))
        for key, leaf, target, value in changed:
            target.copy_(value)
            seen[key, leaf] = value, value._version
        return True

    def hand_out(self, name: str) -> dict:
        """Copies of the static tree ``name``, which the model holds from now
        on: no replay writes them."""
        held = {k: {n: v.clone() for n, v in sub.items()}
                for k, sub in self.trees[name].items()}
        self._agree(name, held)
        return held


class PhaseGraph:
    """``fn`` captured once as a CUDA graph: what the capture returned is
    the graph's output, at the same addresses at every replay.  The graph
    keeps the resident constants it read, and counts the kernel launches
    its capture made (which are taken back off ``LAUNCHES``) at each
    replay."""

    def __init__(self, fn, pool):
        self.graph = torch.cuda.CUDAGraph()
        before = Counter(trace.LAUNCHES)
        try:
            with numerics.pinned() as self.constants, torch.cuda.graph(
                    self.graph, pool=pool, capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            self.launches = Counter(trace.LAUNCHES) - before
            trace.LAUNCHES.subtract(self.launches)
            for name in self.launches:
                if name not in before and not trace.LAUNCHES[name]:
                    del trace.LAUNCHES[name]

    def replay(self):
        self.graph.replay()
        trace.LAUNCHES.update(self.launches)
        return self.out


def capture(what: str, fn, pool):
    """``PhaseGraph(fn, pool)``, or ``FAILED`` with a warning where the
    capture raised: that phase then runs eager."""
    try:
        return PhaseGraph(fn, pool)
    except RuntimeError as e:
        warnings.warn(f"the train step's {what} could not be captured as a CUDA graph and "
                      f"runs eager: {e}", RuntimeWarning, stacklevel=3)
        return FAILED
