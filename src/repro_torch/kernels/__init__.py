"""The port's hand-written kernels: CUDA sources in ``csrc/``, each with a
plain PyTorch version (``<name>/ref.py``) and a wrapper (``<name>/ops.py``).
Below, what the wrappers of the fused quantum-boundary kernels share."""
import threading

import torch

# kernel name -> {device index: int32 (2,) launch counts on that card}
_CARD_COUNTS = {}

# The threads backend's workers reach the wrappers together: each kernel's
# once-per-process and once-per-device set-ups (its ctypes entry, a
# shared-memory limit, its card counts) and the wrappers' launch counters
# are read and written under this lock.
LOCK = threading.RLock()


def count_launch(fn, **deltas):
    """Add each of ``deltas`` to the counter of that name on the wrapper
    ``fn`` (``fn.launches += 1`` and the like), under ``LOCK``."""
    with LOCK:
        for name, n in deltas.items():
            setattr(fn, name, getattr(fn, name) + n)


def card_counts(name, device):
    """The launch counts of kernel ``name`` on the card ``device``: an int32
    tensor [clean, fault variant] that the kernel itself adds one to when it
    runs (block 0, thread 0), so a captured graph's replays count as the
    launches they are; a wrapper's ``.launches`` counts only the launches it
    issues from the host.  Made at the kernel's first launch on the card,
    which must not be inside a capture (the graph would replay its reset)."""
    with LOCK:
        counts = _CARD_COUNTS.setdefault(name, {})
        if device.index not in counts:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{name}: launch the kernel once before capturing it")
            counts[device.index] = torch.zeros(2, dtype=torch.int32, device=device)
        return counts[device.index]


def read_card_counts(reset=False):
    """{kernel name: (clean, fault variant)} launches counted on the card
    (summed over cards; one host read each); with ``reset``, the counts
    are set to 0 after the read."""
    out = {}
    with LOCK:
        cards = {name: list(counts.values()) for name, counts in _CARD_COUNTS.items()}
    for name, counts in cards.items():
        total = [0, 0]
        for x in counts:
            total = [a + b for a, b in zip(total, x.tolist())]
            if reset:
                x.zero_()
        out[name] = tuple(total)
    return out


def unit_rows(x):
    """``x`` (S, n, C) with unit-stride rows, and its strides over (S, n) in
    elements: the AER inbox leaves ``in_buf`` a strided view, which the
    fused kernels read in place."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


def check_inputs(fn, device, specs, strided=()):
    """Raises ``ValueError`` unless each ``(name, tensor, dtype, shape)`` of
    ``specs`` whose tensor is given lies on ``device`` with that dtype and
    shape and is contiguous (the names in ``strided`` need only unit-stride
    rows, as ``unit_rows`` gives)."""
    for name, x, dtype, shape in specs:
        if x is None:
            continue
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
            raise ValueError(f"{fn}: {name} must be {dtype} {shape} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not (x.stride(-1) == 1 if name in strided else x.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous")
