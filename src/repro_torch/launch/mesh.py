"""Device meshes on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over one process
per device: NCCL between cards, gloo between CPU processes.  Every rank runs
the same program, as the reference's single-controller program does: each
builds the same job from the same seeds and reads the same global results.
The process group comes first (``init_world``: its address, world size and
rank given, never read from the environment); the mesh functions below
then lay the world out with the reference's axis names.  On the card a
mesh's ``device=None`` is this rank's card (``mesh_device``).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import tree


def init_world(init_method: str, rank: int, world_size: int, device=None,
               timeout_s: float = 300.0):
    """Join the process group: NCCL on the card (this rank's card is
    ``rank % device_count``), gloo on the CPU (``device="cpu"``).  A rank that
    waits on a collective longer than ``timeout_s`` raises, so a rank that
    failed cannot hang the others for good.  There is no fallback from NCCL
    to gloo."""
    dev = tree.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape, axes, device=None):
    """A mesh of ``shape`` over the world's processes, dims named ``axes``;
    the world must hold exactly ``prod(shape)`` ranks."""
    dev = tree.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_world first")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) = one pod of 256 devices (data x model); (2, 16, 16) = two
    pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, device=None):
    """A small (data, model) mesh over a test's processes."""
    return make_mesh((data, model), ("data", "model"), device)


def chips(mesh) -> int:
    return mesh.size()


def make_serve_mesh(n_devices: int | None = None, device=None):
    """Flat 1-D serving mesh, axis ``jobs``, over the whole world (or
    ``n_devices`` of it).  The serving job axis
    (``core/controller.sharded_job_mega_fn``, ``serve/snn_serve.py``) needs
    no collective inside a round: each rank runs its job shard alone."""
    return make_mesh((n_devices or dist.get_world_size(),), ("jobs",), device)


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
