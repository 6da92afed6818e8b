"""PyTorch/CUDA port of the neuromorphic virtual platform (VP).

The JAX package ``repro`` is the reference; this package mirrors its module
names and public functions (``repro_torch.core.segmentation.build`` is the
counterpart of ``repro.core.segmentation.build``, and so on) and keeps its
state trees: nested dicts of tensors with the same keys, shapes and dtypes.

This slice runs the CPU-free spiking path: ``snn.build_snn`` ->
``core.controller.Controller.run`` over ``vp.platform.make_segment_step``
with ``has_cpu=False``, the LIF tick running as a hand-written CUDA kernel
(``kernels/csrc/lif_step.cu``).  Options outside that path raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Entry points put state on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of moving to the CPU.
The package imports torch, numpy and the standard library only.
"""
