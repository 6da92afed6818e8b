"""PyTorch/CUDA port of the neuromorphic virtual platform (VP).

The JAX package ``repro`` is the reference; this package mirrors its module
names and public functions (``repro_torch.core.segmentation.build`` is the
counterpart of ``repro.core.segmentation.build``, and so on) and keeps its
state trees: nested dicts of tensors with the same keys, shapes and dtypes.

Ported so far: the CPU-free spiking path (``snn.build_snn`` ->
``core.controller.Controller.run`` over ``vp.platform.make_segment_step``),
the dense VMM offload on live RISC-V CPUs (``core.segmentation.build(
programs=...)``), and seeded fault injection on both (``faults``), with
the LIF tick, the crossbar VMM (each with its fault variant) and the
instruction-slot scan as hand-written CUDA kernels under ``kernels/csrc/``;
and, from the LM stack, falcon-mamba-7b serving (``models.model.build`` ->
``serve.serve_step.greedy_generate``) with the Mamba-1 selective scan as a
CUDA kernel (``kernels/csrc/ssm_scan.cu``).
Options outside these paths raise ``NotImplementedError`` naming the
ROADMAP item that brings them.

Entry points put state on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of moving to the CPU.
The package imports torch, numpy and the standard library only.
"""
