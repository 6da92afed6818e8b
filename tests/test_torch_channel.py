"""The port's channel functions against repro.core.channel on random boxes,
bit for bit: every function from ``empty_box`` to ``pack_pending``,
including appends past capacity and routes that overflow an inbox."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.core import channel as jch
from repro_torch.core import channel as ch
from torch_parity import assert_tree_equal

CAP = 8
FIELDS = {"box": ch.FIELDS, "pending": ch.PENDING_FIELDS}

PROP = settings(max_examples=25, deadline=None)


def _rand_box(rng, kind, batch, cap, count_hi):
    box = {f: rng.integers(-300, 300, (*batch, cap)).astype(np.int32)
           for f in FIELDS[kind]}
    box["valid"] = rng.random((*batch, cap)) < rng.random()
    box["count"] = rng.integers(0, count_hi + 1, batch).astype(np.int32)
    if kind == "pending":
        for f in ("max_count", "routed_total", "lost_total"):
            box[f] = rng.integers(0, 3 * cap, batch).astype(np.int32)
    return box


def _both(tree_np):
    return (jax.tree.map(jnp.asarray, tree_np),
            {k: torch.from_numpy(np.array(v)) for k, v in tree_np.items()})


def test_empty_boxes_match():
    assert_tree_equal(jch.empty_box(CAP), ch.empty_box(CAP))
    assert_tree_equal(jch.empty_pending(CAP), ch.empty_pending(CAP))


@PROP
@given(seed=st.integers(0, 2**32 - 1), mask=st.booleans(),
       count_hi=st.sampled_from([CAP - 2, CAP + 3]))
def test_box_append_matches(seed, mask, count_hi):
    rng = np.random.default_rng(seed)
    jbox, tbox = _both(_rand_box(rng, "box", (), CAP, count_hi))
    vals = [int(x) for x in rng.integers(-50, 50, 5)]
    want = jch.box_append(jbox, jnp.asarray(mask), *vals)
    got = ch.box_append(tbox, torch.tensor(mask), *vals)
    assert_tree_equal(want, got, "box_append")


@PROP
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(1, 12),
       count_hi=st.sampled_from([CAP - 3, CAP + 2]), scalar=st.booleans())
def test_box_append_bulk_matches(seed, n, count_hi, scalar):
    rng = np.random.default_rng(seed)
    jbox, tbox = _both(_rand_box(rng, "box", (), CAP, count_hi))
    mask = rng.random(n) < 0.6
    vals = [rng.integers(-50, 50, n).astype(np.int32) for _ in range(5)]
    if scalar:  # the step passes constants for kind and data
        vals[0], vals[3] = 5, 1
    as_j = lambda v: v if isinstance(v, int) else jnp.asarray(v)
    as_t = lambda v: v if isinstance(v, int) else torch.from_numpy(v)
    want = jch.box_append_bulk(jbox, jnp.asarray(mask), *map(as_j, vals))
    got = ch.box_append_bulk(tbox, torch.from_numpy(mask), *map(as_t, vals))
    assert_tree_equal(want, got, "box_append_bulk")


@PROP
@given(seed=st.integers(0, 2**32 - 1))
def test_pack_and_pack_pending_match(seed):
    rng = np.random.default_rng(seed)
    jbox, tbox = _both(_rand_box(rng, "box", (), CAP, CAP))
    assert_tree_equal(jch.pack(jbox), ch.pack(tbox), "pack")
    jpen, tpen = _both(_rand_box(rng, "pending", (), CAP, CAP))
    assert_tree_equal(jch.pack_pending(jpen), ch.pack_pending(tpen), "pack_pending")


@functools.partial(jax.jit, static_argnums=3)
def _jax_route_merge(outboxes, lat, pending, in_cap):
    fresh = jch.route(outboxes, lat, in_cap)
    return fresh, jax.vmap(jch.merge_pending)(pending, fresh)


@PROP
@given(seed=st.integers(0, 2**32 - 1), s=st.sampled_from([1, 3]),
       in_cap=st.sampled_from([3, CAP + 5]))
def test_route_merge_and_overflow_flag_match(seed, s, in_cap):
    rng = np.random.default_rng(seed)
    out = _rand_box(rng, "box", (s,), CAP, CAP)
    out["dst"] = rng.integers(-1, s + 1, (s, CAP)).astype(np.int32)  # strays too
    lat = rng.integers(1, 100, (s, s)).astype(np.int32)
    jout, tout = _both(out)
    jpen, tpen = _both(_rand_box(rng, "pending", (s,), in_cap, in_cap))
    fresh_j, merged_j = _jax_route_merge(jout, jnp.asarray(lat), jpen, in_cap)
    fresh_t = ch.route(tout, torch.from_numpy(lat), in_cap)
    assert_tree_equal(fresh_j, fresh_t, "route")
    merged_t = ch.merge_pending(tpen, fresh_t)
    assert_tree_equal(merged_j, merged_t, "merge_pending")
    for cap in (in_cap, 2 * in_cap):
        assert bool(jch.inbox_overflowed(merged_j, cap)) == \
            bool(ch.inbox_overflowed(merged_t, cap))
