"""The port's hand-written kernels: CUDA sources in ``csrc/``, each with a
plain PyTorch version (``<name>/ref.py``) and a wrapper (``<name>/ops.py``).
Below, what the wrappers of the fused quantum-boundary kernels share."""


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
