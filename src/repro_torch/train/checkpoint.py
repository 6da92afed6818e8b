"""Checkpointing: atomic, resumable, async, in the reference's numpy/npz
format (counterpart of ``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<N>/`` holding ``shard_0.npz`` (the flat leaves,
``leaf_<i>`` in the reference's flattening order: dicts by sorted key) and
``manifest.json`` (step, leaf count, shapes, dtypes, sha256 of the npz).
A write goes to ``step_<N>.tmp``, renamed only after the manifest is
fsync'd, so a crash mid-write never corrupts the newest valid checkpoint;
``latest_step`` and ``restore`` skip any step whose checksum fails.  A
float32, int8 or int32 tree written by either package restores in the
other.  A bf16 leaf (no numpy dtype on either host) is stored as its
uint16 bits with ``bfloat16`` in the manifest and restored with
``.view(torch.bfloat16)``.

Elasticity, as the reference's: the file holds the global arrays, so a
restore may use another mesh than the save.  ``save(shardings=)`` of a
tree of this rank's blocks gathers the global arrays (every rank calls
it) and rank 0 writes them; ``restore(shardings=)`` gives each rank its
blocks of the new layout.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.common import shard, unshard

_BF16 = "bfloat16"


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def save(ckpt_dir, step: int, tree, async_write: bool = False, shardings=None):
    """Atomic checkpoint write of a tree of tensors.  Returns the final path,
    or the writing thread with ``async_write`` (the device-to-host copies are
    made before it starts).  With ``shardings`` (a tree like ``tree`` of
    ``NamedSharding``), ``tree`` holds this rank's blocks: every rank of the
    mesh calls ``save``, each leaf's global array is all-gathered in turn
    (one leaf's copy at a time on the device), rank 0 writes them and,
    without ``async_write``, the others wait for the write."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    leaves = T.leaves(tree)
    writer = True
    if shardings is not None:
        import torch.distributed as dist

        where = dict(T.leaves(shardings))
        writer = dist.get_rank() == 0
        gathered = []
        for path, x in leaves:
            g = unshard(x, where[path])
            gathered.append((path, g.to("cpu", copy=g is x) if writer else None))
            del g
        leaves = gathered
        if not writer:
            if not async_write:
                dist.barrier()
            return final
    host = [_host(x) for _, x in leaves]
    dtypes = [_BF16 if x.dtype == torch.bfloat16 else str(a.dtype)
              for (_, x), a in zip(leaves, host)]

    def _write():
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "treedef": " ".join(p for p, _ in leaves),
            "n_leaves": len(host),
            "shapes": [list(a.shape) for a in host],
            "dtypes": dtypes,
            "sha256": _sha256(tmp / "shard_0.npz"),
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if shardings is not None:
        dist.barrier()
    return final


def _valid(path: Path) -> bool:
    m, s = path / "manifest.json", path / "shard_0.npz"
    if not (m.exists() and s.exists()):
        return False
    try:
        return _sha256(s) == json.loads(m.read_text())["sha256"]
    except Exception:
        return False


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted((int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                    if not p.name.endswith(".tmp")), reverse=True)
    for s in steps:
        if _valid(ckpt_dir / f"step_{s:08d}"):
            return s
    return None


def restore(ckpt_dir, like_tree, step: int | None = None, device=None, shardings=None):
    """Restore into the structure of ``like_tree`` (a tree of tensors, or of
    specs with ``shape``/``dtype``).  Returns (tree, step).  Each leaf goes
    to its like-leaf's device if that is a tensor, else to ``device``
    (``cuda`` unless given).  With ``shardings`` (a tree like ``like_tree``
    of ``NamedSharding``), each leaf is this rank's block of it, on the
    mesh's device unless ``device`` is given: an elastic restore onto any
    mesh."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    if not _valid(path):
        raise IOError(f"checkpoint {path} failed checksum validation")
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "shard_0.npz")
    leaves = T.leaves(like_tree)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint {path} holds {manifest['n_leaves']} leaves, the tree "
                         f"{len(leaves)}")
    where = dict(T.leaves(shardings)) if shardings is not None else {}
    out = {}
    for i, ((p, like), dt) in enumerate(zip(leaves, manifest["dtypes"])):
        a = data[f"leaf_{i}"]
        x = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if dt == _BF16
             else torch.from_numpy(a))
        if p in where:
            from repro_torch.launch.mesh import mesh_device

            dev = mesh_device(where[p].mesh) if device is None else torch.device(device)
            out[p] = shard(x.to(dev), where[p])
            continue
        dev = like.device if isinstance(like, torch.Tensor) else T.resolve_device(device)
        out[p] = x.to(dev)
    return T.map_with_path(lambda p, _: out[p], like_tree), step


def corrupt_for_test(ckpt_dir, step: int):
    """Failure injection: truncate a checkpoint's data file (tests only)."""
    p = Path(ckpt_dir) / f"step_{step:08d}" / "shard_0.npz"
    with open(p, "r+b") as f:
        f.truncate(max(p.stat().st_size // 2, 1))
