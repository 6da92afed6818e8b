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
telemetry (``obs``: trace rings, ``Controller.stats``/``metrics``) and fleet
serving over a job axis (``serve.snn_serve``); and, from the LM stack, all
ten architectures' configurations and serving (``models.model.build`` ->
``serve.serve_step.greedy_generate``): falcon-mamba-7b with the Mamba-1
selective scan as a CUDA kernel (``kernels/csrc/ssm_scan.cu``), the dense
decoders (qwen3, internlm2, stablelm, granite), the MoE decoders
(llama4-scout, kimi-k2: ``models.moe``), zamba2 (Mamba-2 and a shared
attention block), qwen2-vl (M-RoPE, vision embeddings) and whisper-tiny
(``models.encdec``), in bf16 torch rounded where the reference rounds;
training of all ten (``models.model.Model.loss`` ->
``train.train_step.make_train_step``, AdamW with int8 moments,
checkpoints, compression, decoupled pod rounds; ``launch.train``), the
Mamba-1 scan's gradient a CUDA kernel too; ``vp.workloads.from_arch``,
which tiles an architecture's FFN GEMM onto the VP's crossbars; the VP's
multi-device backends on ``torch.distributed`` (``launch.mesh``: the
controller's ``shard_map`` backend, the sharded job axis and
``SnnServer(mesh=)``); the LM's sharding layer (partition specs at any
``tp``, ``common.shard``/``unshard``), its expert-parallel MoE
(``models.moe.ep_moe``, ``ep_moe_decode``), the ZeRO-1 train step over a
mesh (``make_train_step(mesh=)``), ``device_batch_at(mesh=)`` and
``checkpoint.restore(shardings=)``; tensor parallelism of every other
weight over 'model' as its partition spec splits it (attention heads, the
MLP's ff axis, the vocab, Mamba's ``d_inner``), served and trained;
split-KV decode (every attention cache held as its partition spec splits
it, the decode softmax combined over the ranks); one-card FLOP
accounting (``analysis.roofline``); and the multi-pod dry run
(``launch.dryrun``): every (arch x shape x production mesh) cell's step
run as rank 0 of a fake world of 256 or 512 on fake tensors, its memory,
FLOPs and collective bytes per device counted as it runs
(``analysis.comm_cost``, ``roofline.from_trace``), the counterpart of the
reference's ``launch/dryrun.py`` and ``analysis/hlo_cost.py``.  The port
now does everything the JAX package does.

Entry points put state on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of moving to the CPU.
The package imports torch, numpy and the standard library only.
"""
