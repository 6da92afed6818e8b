"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
JAX package and the PyTorch port compared leaf by leaf through numpy."""
import dataclasses

import jax
import numpy as np

from repro_torch import tree


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


def cfg_fields(cfg):
    """A VPConfig's fields as plain values (timing as a dict)."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg)
            for v in [getattr(cfg, f.name)]}


def carry_across(jax_tree, device="cpu"):
    """The JAX package's tree as the port's tensors (tree.from_numpy)."""
    return tree.from_numpy(jax.tree.map(np.asarray, jax_tree), device)
