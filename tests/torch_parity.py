"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
JAX package and the PyTorch port compared leaf by leaf through numpy."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch import tree


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
