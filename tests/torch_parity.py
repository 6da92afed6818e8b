"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
JAX package and the PyTorch port compared leaf by leaf through numpy."""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import tree

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def single_torch_thread():
    """Run a module's tests with one intra-op torch thread, restoring the
    count after.  The VP's plain versions issue thousands of tiny ops: on a
    host shared by several test workers, each worker's pool of intra-op
    threads spinning over the others' cores slows such a module many times
    over (three tests of tests/test_torch_hybrid.py: 22.8 s with one thread,
    294.1 s with eight, beside five busy processes on eight cores), and
    idle it gains nothing from them.
    A module opts in with ``pytestmark = pytest.mark.usefixtures(...)``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_torch_world(code: str, world_size: int, workdir, timeout: float = 240.0):
    """Run ``code`` in ``world_size`` fresh interpreters, one rank each, for
    a ``torch.distributed`` world on the CPU (gloo).  Each rank reads
    ``RANK``, ``WORLD_SIZE``, ``INIT_METHOD`` (a ``file://`` rendezvous in
    ``workdir``, so concurrent test workers never share a port) and
    ``OUT`` (``workdir``) from its environment.  Every rank is killed once
    one fails or the wall limit ``timeout`` passes, so a rank that raised
    cannot leave another waiting; raises with the ranks' output then."""
    workdir = Path(workdir)
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE=str(world_size),
               INIT_METHOD=f"file://{workdir / 'rendezvous'}", OUT=str(workdir),
               OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world_size)]
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for r, log in enumerate(logs):
        log.seek(0)
        out.append(log.read())
        log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    assert not bad, "".join(f"\n--- rank {r} (exit {procs[r].returncode}):\n{out[r][-3000:]}"
                            for r in bad)
    return out


def assert_tree_equal(jax_tree, torch_tree, what="tree"):
    """Same keys, shapes, dtypes and values, bit for bit."""
    want = tree.leaves(jax.tree.map(np.asarray, jax_tree))
    got = tree.leaves(tree.tree_map(lambda x: x.detach().cpu().numpy(), torch_tree))
    assert [p for p, _ in want] == [p for p, _ in got], \
        f"{what}: keys differ: {[p for p, _ in want]} vs {[p for p, _ in got]}"
    for (path, w), (_, g) in zip(want, got):
        assert w.shape == g.shape, f"{what}{path}: shape {w.shape} vs {g.shape}"
        assert w.dtype == g.dtype, f"{what}{path}: dtype {w.dtype} vs {g.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{path}")


def assert_dict_equal(want, got, what="dict"):
    """Nested dicts of numpy arrays (``stats()``, ``metrics()``): the same
    keys in the same order, dtypes, shapes and values."""
    assert list(want) == list(got), f"{what}: keys {list(want)} vs {list(got)}"
    for k in want:
        if isinstance(want[k], dict):
            assert_dict_equal(want[k], got[k], f"{what}/{k}")
            continue
        w, g = np.asarray(want[k]), got[k]
        assert isinstance(g, np.ndarray), f"{what}/{k}: {type(g)}"
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f"{what}/{k}: {w.dtype} {w.shape} vs {g.dtype} {g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")


def cfg_fields(cfg):
    """A VPConfig's fields as plain values (timing as a dict)."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg)
            for v in [getattr(cfg, f.name)]}


def carry_across(jax_tree, device="cpu"):
    """The JAX package's tree as the port's tensors (tree.from_numpy)."""
    return tree.from_numpy(jax.tree.map(np.asarray, jax_tree), device)


def carry_cfg(jax_cfg):
    """The JAX package's VPConfig as the port's (the same fields)."""
    from repro_torch import faults
    from repro_torch.vp import memory
    from repro_torch.vp import platform as pf

    kw = cfg_fields(jax_cfg)
    kw["timing"] = memory.Timing(**kw["timing"])
    if kw["faults"] is not None:
        kw["faults"] = faults.FaultConfig(**kw["faults"])
    return pf.VPConfig(**kw)


def carry_request(jax_request, device="cpu"):
    """The JAX package's ``SnnRequest`` as the port's: its cfg, its trees (a
    trace ring among them, if it has one) and its meta."""
    from repro_torch.serve.snn_serve import SnnRequest

    return SnnRequest(carry_cfg(jax_request.cfg), carry_across(jax_request.states, device),
                      carry_across(jax_request.pending, device), jax_request.meta,
                      jax_request.expected_counts)


# ---------------------------------------------------------------------------
# the LM families: the same weights and inputs on both sides


def jax_params(weights):
    """``common.init_numpy``'s tree as the JAX package's parameters: float32
    leaves as they are, a bf16 leaf's uint16 bits viewed as bfloat16."""
    import jax.numpy as jnp

    return tree.map_with_path(
        lambda _, x: jnp.asarray(x).view(jnp.bfloat16) if x.dtype == np.uint16
        else jnp.asarray(x), weights)


def lm_batches(batch):
    """A batch of numpy arrays as the port's tensors and the JAX package's
    arrays: float32 arrays (embeddings) in bf16 on both sides, integer
    arrays (tokens, positions) as they are."""
    import jax.numpy as jnp

    def both(x):
        if x.dtype == np.float32:
            return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
        return torch.from_numpy(x), jnp.asarray(x)

    pairs = {k: both(v) for k, v in batch.items()}
    return {k: t for k, (t, _) in pairs.items()}, {k: j for k, (_, j) in pairs.items()}


def pad_jax_cache(jcfg, jcache, seq, batch, pad_to):
    """The JAX package's ``greedy_generate(pad_to=)`` padding of a cache:
    each leaf's sequence axis (its ``cache_seq_axes``) zero-padded."""
    import jax.numpy as jnp
    from repro.serve.serve_step import cache_seq_axes

    axes = cache_seq_axes(jcfg, jcache, seq, batch)
    flat, treedef = jax.tree.flatten(jcache)

    def pad(x, ax):
        if ax is None:
            return x
        width = [(0, 0)] * x.ndim
        width[ax] = (0, pad_to - x.shape[ax])
        return jnp.pad(x, width)

    return jax.tree.unflatten(treedef, [pad(x, ax) for x, ax in zip(flat, axes)])


def decode_batch(cfg, tokens, pos):
    """One decode step's batch on both sides (``serve_step.decode_batch``'s):
    the tokens (B, 1), and for M-RoPE every row at ``pos``."""
    import jax.numpy as jnp

    from repro_torch.serve.serve_step import decode_batch as ours

    db = ours(cfg, torch.from_numpy(tokens), pos)
    return db, {k: jnp.asarray(v.numpy()) for k, v in db.items()}


def jax_greedy_margins(jmodel, jparams, jbatch, steps, pad_to, prefill=None):
    """The JAX package's greedy tokens and top-1/top-2 logit margins, from
    its own loop (``greedy_generate``'s, with ``pad_to``; ``prefill`` in
    place of ``jmodel.prefill`` if given)."""
    import jax.numpy as jnp

    b, seq = jbatch["tokens"].shape
    cache, lg = (prefill or jmodel.prefill)(jparams, jbatch)
    cache = pad_jax_cache(jmodel.cfg, cache, seq, b, pad_to)
    step = jax.jit(jmodel.decode_step)
    toks, margins = [], []
    for i in range(steps):
        last = np.asarray(lg[:, -1], np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        toks.append(np.argmax(last, axis=-1).astype(np.int32))
        margins.append(top2[:, 1] - top2[:, 0])
        if i < steps - 1:
            _, db = decode_batch(jmodel.cfg, toks[-1][:, None], seq + i)
            lg, cache = step(jparams, cache, db, jnp.int32(seq + i))
    return np.stack(toks, 1), np.stack(margins, 1)


def same_tokens(got, want, margins, tol):
    """Tokens equal wherever the JAX margin exceeds ``tol``; a row is not
    compared past a position where they differ.  Returns the count compared."""
    compared = 0
    for r in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margins[r, i] <= tol:
                if got[r, i] != want[r, i]:
                    break
                continue
            assert got[r, i] == want[r, i], (r, i, got[r], want[r], margins[r])
            compared += 1
    assert compared >= want.size // 2, (compared, margins)
    return compared


def to_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, tol, what):
    np.testing.assert_allclose(to_np(got), to_np(want), err_msg=what, **tol)
