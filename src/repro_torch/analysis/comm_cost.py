"""What one rank's step does, counted as the step runs (counterpart of
``repro/analysis/hlo_cost.py``).

The reference reads a compiled, SPMD-partitioned HLO module: its FLOPs,
bytes accessed and collectives, per device.  The port has no compiler: its
explicit SPMD code runs every collective itself (``launch/mesh.py``), so
the same numbers are counted while one rank's step runs, on real tensors or
on fake ones (``launch/dryrun.py``):

- ``CollectiveCounter`` notes every collective ``launch/mesh.py`` issues or
  skips: its name in ``launch/mesh.py`` (``all_reduce_max`` is a
  ``pmax``, ``argmax`` the greedy token's two gathers), its kind
  (``COLLECTIVES``' names, as ``hlo_cost`` names them), the mesh axes it
  runs over (in the mesh's order) and its operand bytes as ``hlo_cost``
  counts them (the input block of an all-gather; the tensor of an
  all-reduce, in float32 where a 16-bit sum is promoted; the whole input
  of a reduce-scatter).  A collective over axes of size 1 is skipped:
  counted apart, it moves no bytes.
- ``LiveBytes`` keeps a running total of the bytes of the tensor storages
  the step's ops make, each storage counted once and subtracted when it is
  freed (a weakref finalizer), and the peak of that total: the memory the
  step needs beyond its arguments, the counterpart of XLA's
  ``temp_size_in_bytes`` (it includes the outputs alive at the peak).

FLOPs and bytes accessed are ``analysis.roofline``'s counts
(``FlopCounterMode`` and its byte-counting mode); ``roofline.from_trace``
runs all four over one step.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch import mesh as M

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def axes_name(axes) -> str:
    """The key of a tuple of mesh axes in a record: the names joined by '+'."""
    return "+".join(axes)


KIND = {"all_gather": "all-gather", "argmax": "all-gather", "all_reduce": "all-reduce",
        "all_reduce_max": "all-reduce", "reduce_scatter": "reduce-scatter"}


class CollectiveCounter:
    """While open, every collective of ``launch/mesh.py``: ``calls`` maps
    (name, axes, skipped) to [count, operand bytes]."""

    def __enter__(self):
        self.calls = {}
        M._TALLIES.append(self)
        return self

    def __exit__(self, *exc):
        M._TALLIES.remove(self)

    def add(self, op: str, axes: tuple[str, ...], nbytes: int, skipped: bool):
        entry = self.calls.setdefault((op, tuple(axes), skipped), [0, 0])
        entry[0] += 1
        entry[1] += nbytes

    def records(self) -> list[dict]:
        """One record per (name, axes, skipped), sorted."""
        return [{"op": op, "kind": KIND[op], "axes": list(a), "skipped": s, "count": n,
                 "bytes": b} for (op, a, s), (n, b) in sorted(self.calls.items())]

    def bytes_by(self, what: str) -> dict:
        """Operand bytes of the issued collectives by "kind" or by "axes"."""
        out = {}
        for (op, axes, skipped), (_, b) in self.calls.items():
            if not skipped:
                key = KIND[op] if what == "kind" else axes_name(axes)
                out[key] = out.get(key, 0) + b
        return out

    def counts(self, skipped: bool) -> dict:
        """{"kind over axes": calls}, of the skipped or the issued ones."""
        out = {}
        for (op, axes, s), (n, _) in sorted(self.calls.items()):
            if s == skipped:
                key = f"{KIND[op]} over {axes_name(axes)}"
                out[key] = out.get(key, 0) + n
        return out


class LiveBytes(TorchDispatchMode):
    """Bytes of the live tensor storages made by the ops run under it:
    ``live`` now, ``peak`` the most at any time.  The storages of
    ``arguments`` (the step's inputs, made before it) are known from the
    start and never counted."""

    def __init__(self, arguments=()):
        super().__init__()
        self.live = self.peak = 0
        self._seen = weakref.WeakSet()
        self.argument_bytes = 0
        for t in tree_flatten(arguments)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen.add(st)
                    self.argument_bytes += st.nbytes()
        self._arguments = weakref.WeakSet(self._seen)

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen.add(st)
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, n)
        return out

    def output_bytes(self, outputs) -> tuple[int, int]:
        """(bytes of the distinct storages of ``outputs``, the part of them
        that is an argument's storage: XLA's output and alias sizes)."""
        seen, total, alias = set(), 0, 0
        for t in tree_flatten(outputs)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) not in seen:
                    seen.add(id(st))
                    total += st.nbytes()
                    alias += st.nbytes() if st in self._arguments else 0
        return total, alias
