"""The fused dispatch's round loop on the card: the conditional nodes of
``kernels/csrc/dispatch_graph.cu`` around a round and a flag check that
PyTorch captured, built into one executable CUDA graph.

``DispatchGraph(round_graph, check_graph, running, at)`` takes two
``torch.cuda.CUDAGraph(keep_graph=True)`` captures (uninstantiated) and the
controller's 0-d bool predicates.  One ``replay()`` runs rounds on the
current stream while ``running`` holds (a WHILE node), each round's check
only where ``at`` holds (an IF node).  Both predicates are read on the
card.  The object keeps the two PyTorch graphs, and with them
their memory pools, alive for as long as the executable graph lives.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.kernels import build

# a captured body's node census from dispatch_graph_build, in its order
CENSUS = ("nodes", "kernels", "memcpys", "memsets", "conditionals", "child_graphs",
          "empties", "other")
_fns = {}


def _lib():
    if not _fns:
        lib = build.load("dispatch_graph")
        lib.dispatch_graph_build.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
        lib.dispatch_graph_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dispatch_graph_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.dispatch_graph_build, lib.dispatch_graph_launch,
                   lib.dispatch_graph_destroy):
            fn.restype = ctypes.c_int
        lib.dispatch_graph_error.argtypes = [ctypes.c_int]
        lib.dispatch_graph_error.restype = ctypes.c_char_p
        lib.dispatch_graph_failed_step.restype = ctypes.c_int
        _fns.update(build=lib.dispatch_graph_build, launch=lib.dispatch_graph_launch,
                    destroy=lib.dispatch_graph_destroy, error=lib.dispatch_graph_error,
                    failed_step=lib.dispatch_graph_failed_step)
    return _fns


def _error(err):
    return _fns["error"](err).decode()


class DispatchGraph:
    def __init__(self, round_graph, check_graph, running, at):
        for name, x in (("running", running), ("at", at)):
            if x.dtype != torch.bool or x.dim() != 0 or x.device.type != "cuda":
                raise ValueError(f"dispatch graph: {name} must be a 0-d bool CUDA tensor")
        fns = _lib()
        exec_ = ctypes.c_void_p()
        census = (ctypes.c_int * (2 * len(CENSUS)))()
        stream = torch.cuda.current_stream(running.device).cuda_stream
        err = fns["build"](round_graph.raw_cuda_graph(), check_graph.raw_cuda_graph(),
                           running.data_ptr(), at.data_ptr(), stream,
                           ctypes.byref(exec_), census)
        if err != 0:
            raise RuntimeError(f"dispatch graph: building the conditional graph failed at "
                               f"step {fns['failed_step']()} of csrc/dispatch_graph.cu: "
                               f"CUDA error {err} ({_error(err)})")
        # three setter kernels, the WHILE and IF nodes, two child graphs and
        # the captured bodies' nodes (-1: not counted)
        bodies = [dict(zip(CENSUS, census[i:i + len(CENSUS)])) for i in (0, len(CENSUS))]
        self.census = {"round": bodies[0], "check": bodies[1],
                       "nodes": -1 if min(b["nodes"] for b in bodies) < 0 else
                       7 + sum(b["nodes"] for b in bodies),
                       "conditionals": 2}
        self._exec = exec_.value
        # the captured bodies' memory lives in their graphs' pools
        self._keep = (round_graph, check_graph, running, at)
        self._free = weakref.finalize(self, fns["destroy"], self._exec)

    def replay(self):
        stream = torch.cuda.current_stream(self._keep[2].device).cuda_stream
        err = _fns["launch"](self._exec, stream)
        if err != 0:
            raise RuntimeError(f"dispatch graph launch failed: CUDA error {err} "
                               f"({_error(err)})")
