"""The port's sharding layer of the LM stack against the JAX package's, in
one process: spec trees (keys, shapes, dtypes, partition specs, init
kinds) of all ten full configurations at tp 1 and 16, the FSDP policy,
``input_specs`` and ``cache_specs`` of every ``SHAPES`` cell, the ZeRO-1
layouts of gradients and moments; the padded-head forward of llama4-scout's
smoke configuration at tp = 3 (ROADMAP F8); ``ep_moe`` and
``ep_moe_decode`` on a mesh of one (an in-process gloo world of 1) against
the JAX package's on its one-device mesh; and ROADMAP F7, the reference's
``ep_moe_decode`` past its capacity.

Tolerances.  The expert-parallel paths are bf16 with the reference's ops in
its order, so on a mesh of one the port gives the JAX package's outputs
but for bf16 sums taken in another order: 0.00098 (prefill) and 0.0 (decode)
apart at outputs up to 4.7 (kimi-k2's smoke block at d_model 64; measured
with one torch thread, torch 2.13 and jax 0.9 on a CPU).  They are held at
2e-2 (rtol and atol), the bound tests/test_distributed.py and
tests/test_perf_paths.py hold the JAX package's own mesh paths to against
``dense_moe``, set by the JAX package's own distance between its mesh and
no-mesh outputs: 0.0156 (prefill) and 0.0078 (decode) on these inputs.
aux is float32 on both sides, held at rtol 1e-5.  The losses at tp = 1 and
3 agree to float32 rounding (bf16 GEMMs, float32 loss); held at 1e-4
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro import configs as jconfigs
from repro.common import DTypePolicy as JaxPolicy
from repro.configs.base import SHAPES
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.train import optimizer as jax_opt
from repro.train import train_step as jax_train_step
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import DTypePolicy, P, init_numpy, init_params
from repro_torch.launch import mesh as M
from repro_torch.models import layers, moe
from repro_torch.models import model as tmodel
from repro_torch.train import data, optimizer, train_step
from torch_parity import jax_params, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

ARCHS = jconfigs.ARCH_IDS
EP = dict(rtol=2e-2, atol=2e-2)
LOSS_RTOL = 1e-4


def _dtype(d):
    return np.dtype(d).name if not isinstance(d, torch.dtype) else str(d).removeprefix("torch.")


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        or hasattr(x, "pspec") or isinstance(x, jax.ShapeDtypeStruct))]


def _spec_rows(tree, jax_side):
    """[(shape, dtype, pspec entries, init, scale)] in flattening order."""
    leaves = _jax_leaves(tree) if jax_side else T.leaves(tree)
    return [(tuple(s.shape), _dtype(s.dtype), tuple(s.pspec), s.init, s.scale)
            for _, s in leaves]


def _pspec_rows(tree, jax_side):
    leaves = _jax_leaves(tree) if jax_side else T.leaves(tree)
    return [tuple(p) for _, p in leaves]


def _sds_rows(tree, jax_side):
    leaves = _jax_leaves(tree) if jax_side else T.leaves(tree)
    return [(tuple(s.shape), _dtype(s.dtype)) for _, s in leaves]


# ---------------------------------------------------------------------------
# spec trees and layouts (nothing allocated)


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_jax(arch, tp):
    """``build(cfg, tp).specs``: the same keys, shapes, dtypes, partition
    specs (FSDP respec included), init kinds and scales."""
    want = jax_model.build(jconfigs.get_config(arch), tp=tp).specs
    got = tmodel.build(configs.get_config(arch), tp=tp).specs
    assert [p for p, _ in T.leaves(got)] == [p for p, _ in T.leaves(
        jax.tree.map(lambda s: 0, want, is_leaf=lambda x: hasattr(x, "pspec")))]
    assert _spec_rows(got, False) == _spec_rows(want, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_policy_matches_jax(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert tmodel.needs_fsdp(cfg) == jax_model.needs_fsdp(jcfg)
    for tp in (1, 2, 16):
        assert tmodel.fsdp_params(cfg, tp) == jax_model.fsdp_params(jcfg, tp), tp
    assert tmodel.TP == layers.TP == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_jax(arch):
    """Every ``SHAPES`` cell: ``input_specs``' stand-ins and partition specs,
    and ``cache_specs``' (shape tree, pspec tree) at tp 1 and 16."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for shape in SHAPES:
        jin, jps = jax_model.input_specs(jcfg, shape)
        tin, tps = tmodel.input_specs(cfg, shape)
        assert list(tin) == list(jin) and list(tps) == list(jps), shape
        assert [(tuple(v.shape), _dtype(v.dtype)) for v in tin.values()] == \
            [(tuple(v.shape), _dtype(v.dtype)) for v in jin.values()], shape
        assert [tuple(v) for v in tps.values()] == [tuple(v) for v in jps.values()], shape
        for tp in (1, 16):
            jsds, jpsp = jax_model.cache_specs(jcfg, shape, tp=tp)
            tsds, tpsp = tmodel.cache_specs(cfg, shape, tp=tp)
            assert _sds_rows(tsds, False) == _sds_rows(jsds, True), (shape, tp)
            assert _pspec_rows(tpsp, False) == _pspec_rows(jpsp, True), (shape, tp)
            assert [p for p, _ in T.leaves(tsds)] == [p for p, _ in T.leaves(tpsp)]


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_layouts_match_jax(arch):
    """``zero1_pspec`` of every leaf at tp 16, ``grad_pspecs`` and
    ``opt_specs`` with float32 and int8 moments (the scale's spec too)."""
    jm = jax_model.build(jconfigs.get_config(arch), tp=16)
    tm = tmodel.build(configs.get_config(arch), tp=16)
    assert [tuple(optimizer.zero1_pspec(s)) for _, s in T.leaves(tm.specs)] == \
        [tuple(jax_opt.zero1_pspec(s)) for _, s in _jax_leaves(jm.specs)]
    assert _pspec_rows(train_step.grad_pspecs(tm), False) == \
        _pspec_rows(jax_train_step.grad_pspecs(jm), True)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        got = optimizer.opt_specs(tm.specs, optimizer.OptConfig(moments_dtype=tdt))
        want = jax_opt.opt_specs(jm.specs, jax_opt.OptConfig(moments_dtype=jdt))
        assert _spec_rows(got, False) == _spec_rows(want, True), tdt


def test_zero1_pspec_rules():
    """The largest free axis divisible by 16; none when 'data' is used or
    no axis qualifies."""
    from repro.common import ParamSpec as JSpec
    from repro_torch.common import P, ParamSpec

    cases = [((64, 48), P()), ((64, 48), P("model")), ((15, 17), P()),
             ((32, 64), P(None, "data")), ((16, 16, 8), P(("data", "pod")))]
    jp = jax.sharding.PartitionSpec
    for shape, ps in cases:
        got = optimizer.zero1_pspec(ParamSpec(shape, torch.float32, ps))
        want = jax_opt.zero1_pspec(JSpec(shape, jnp.float32, jp(*ps)))
        assert tuple(got) == tuple(want), (shape, ps)


# ---------------------------------------------------------------------------
# the padded-head forward (ROADMAP F8)

SCOUT = "llama4-scout-17b-a16e"


def _padded_weights(weights, cfg, tp):
    """tp = 1 weights carried into the tp tree: wq's and wo's pad heads zero."""
    hq = layers.padded_heads(cfg, tp)

    def pad(path, x):
        if path.endswith("/attn/wq"):
            return np.concatenate([x, np.zeros(x.shape[:2] + (hq - x.shape[2],) + x.shape[3:],
                                               x.dtype)], axis=2)
        if path.endswith("/attn/wo"):
            return np.concatenate([x, np.zeros((x.shape[0], hq - x.shape[1]) + x.shape[2:],
                                               x.dtype)], axis=1)
        return x

    return T.map_with_path(pad, weights)


def test_padded_heads_forward_matches_jax_and_regroups_kv():
    """llama4-scout's smoke config (4 heads, 2 KV heads) at tp = 3 pads its
    query heads to 6; with the tp = 1 weights carried across (pad heads
    zero), the port's loss equals the JAX package's ``build(cfg, tp=3)``'s,
    and both differ from tp = 1's: ``expand_kv`` repeats each KV head 3 times
    where it repeated it 2, so real head 2 reads KV head 0, not 1 (F8)."""
    cfg, jcfg = configs.get_smoke_config(SCOUT), jconfigs.get_smoke_config(SCOUT)
    assert layers.padded_heads(cfg, 3) == jax_model.L.padded_heads(jcfg, 3) == 6
    weights = init_numpy(tmodel.build(cfg).specs, seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    losses = {}
    for tp in (1, 3):
        w = _padded_weights(weights, cfg, tp)
        m, jm = tmodel.build(cfg, tp=tp), jax_model.build(jcfg, tp=tp)
        assert [tuple(s.shape) for _, s in T.leaves(m.specs)] == \
            [tuple(np.shape(x)) for _, x in T.leaves(w)]
        got = float(m.loss(tmodel.params_from_numpy(m.specs, w, "cpu"),
                           {"tokens": torch.from_numpy(tokens)})[0])
        want = float(jm.loss(jax_params(w), {"tokens": jnp.asarray(tokens)})[0])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (tp, got, want)
        losses[tp] = (got, want)
    assert abs(losses[3][1] - losses[1][1]) > 0.05, losses  # the JAX package moves
    assert abs(losses[3][0] - losses[1][0]) > 0.05, losses  # and the port with it
    o = torch.ones(1, 1, 6, 1)
    assert layers.mask_pad_heads(cfg, o)[0, 0, :, 0].tolist() == [1, 1, 1, 1, 0, 0]
    k = torch.arange(2.0).reshape(1, 1, 2, 1)
    assert layers.expand_kv(k, 6)[0, 0, :4, 0].tolist() == [0, 0, 0, 1]


# ---------------------------------------------------------------------------
# the expert-parallel paths on a mesh of one

KIMI = "kimi-k2-1t-a32b"


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A (data, model) = (1, 1) mesh of an in-process gloo world of 1, and
    the JAX package's one-device mesh."""
    import torch.distributed as dist

    rdv = tmp_path_factory.mktemp("world1") / "rendezvous"
    M.init_world(f"file://{rdv}", 0, 1, device="cpu", timeout_s=60)
    try:
        yield M.make_test_mesh(1, 1, device="cpu"), compat.make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _moe_case(n_experts=None, seed=0):
    """kimi-k2's smoke MoE block at d_model 64 on both sides, weights from
    ``init_numpy``."""
    kw = dict(d_model=64)
    cfg, jcfg = (dataclasses.replace(c, **kw) for c in (configs.get_smoke_config(KIMI),
                                                         jconfigs.get_smoke_config(KIMI)))
    if n_experts:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_experts=n_experts))
                     for c in (cfg, jcfg))
    weights = init_numpy(moe.moe_specs(cfg), seed=seed)
    return cfg, jcfg, weights


def _jax_moe(jcfg, jp, jx, jmesh, fsdp, decode):
    with compat.set_mesh(jmesh):
        return jax.jit(lambda p, x: jax_moe.apply_moe(jcfg, p, x, JaxPolicy(), mesh=jmesh,
                                                      fsdp=fsdp, decode=decode))(jp, jx)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("decode", [False, True])
def test_ep_moe_on_a_mesh_of_one_matches_jax(mesh1, decode, fsdp):
    """``apply_moe(mesh=)`` takes ``ep_moe`` (prefill shape) or
    ``ep_moe_decode`` (decode shape, ``decode=True``) on the gloo world of 1,
    against the JAX package's ``shard_map`` on its one device."""
    mesh, jmesh = mesh1
    cfg, jcfg, weights = _moe_case()
    shape = (4, 1, 64) if decode else (4, 16, 64)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    params = T.tree_map(torch.from_numpy, weights)
    calls = []
    real = {"ep_moe": moe.ep_moe, "ep_moe_decode": moe.ep_moe_decode}
    for name, fn in real.items():
        setattr(moe, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    try:
        y, aux = moe.apply_moe(cfg, params, torch.from_numpy(x), DTypePolicy(), mesh=mesh,
                               fsdp=fsdp, decode=decode)
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)
    assert calls == ["ep_moe_decode" if decode else "ep_moe"]
    jy, jaux = _jax_moe(jcfg, jax_params(weights), jnp.asarray(x), jmesh, fsdp, decode)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == shape
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **EP)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    dense, _ = moe.dense_moe(cfg, params, torch.from_numpy(x), DTypePolicy())
    np.testing.assert_allclose(y.float().numpy(), dense.float().numpy(), **EP)


def test_apply_moe_falls_to_dense_where_the_experts_do_not_divide(mesh1):
    """A 'model' axis that does not divide the expert count, or a mesh with
    no 'model' axis, takes ``dense_moe``, as the reference routes it."""
    import torch.distributed as dist  # noqa: F401

    cfg, _, weights = _moe_case()
    params = T.tree_map(torch.from_numpy, weights)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 64)).astype(np.float32))
    seg = M.make_mesh((1,), ("segment",), device="cpu")
    assert not moe.expert_parallel(cfg, seg) and moe.expert_parallel(cfg, mesh1[0])
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=7))
    assert moe.expert_parallel(odd, mesh1[0])  # 7 % 1 == 0: a mesh of one divides any count
    y, aux = moe.apply_moe(cfg, params, x, DTypePolicy(), mesh=seg)
    want, waux = moe.dense_moe(cfg, params, x, DTypePolicy())
    assert torch.equal(y, want) and torch.equal(aux, waux)


def _f7_input():
    """ROADMAP F7's input: kimi-k2's smoke block with 64 experts (k = 2),
    64 decode tokens from ``jax.random.normal(PRNGKey(1))``, a router whose
    first two columns are ``outer(sign(mean_t x), [2, 1])`` and the others 0:
    most tokens pick experts 0 and 1, past the cap of 32."""
    cfg, jcfg, weights = _moe_case(n_experts=64)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (64, 1, 64)), np.float32)
    router = np.zeros_like(weights["router"])
    router[:, :2] = np.outer(np.sign(x.reshape(64, 64).mean(0)), [2.0, 1.0])
    weights = dict(weights, router=router.astype(np.float32))
    return cfg, jcfg, weights, x


def test_ep_moe_decode_overflow_is_dropped_not_misrouted(mesh1):
    """F7.  The reference's ``ep_moe_decode`` does not mask assignments past
    the capacity: their slot falls into the next expert's rows, so tokens read
    another expert's output and it differs from ``dense_moe`` by far more
    than rounding.  The port drops them, as ``ep_moe`` does: its output
    equals ``dense_moe``'s formula with the gates of the ``pos >= cap``
    assignments zeroed (computed here)."""
    mesh, jmesh = mesh1
    cfg, jcfg, weights, x = _f7_input()
    jp = jax_params(weights)
    jy, _ = _jax_moe(jcfg, jp, jnp.asarray(x), jmesh, False, True)
    jdense, _ = jax_moe.dense_moe(jcfg, jp, jnp.asarray(x), JaxPolicy())
    jerr = np.abs(np.asarray(jy, np.float32) - np.asarray(jdense, np.float32)).max(axis=(1, 2))
    assert jerr.max() > 1.0 and (jerr > 0.1).sum() >= 16, jerr

    params = T.tree_map(torch.from_numpy, weights)
    xt = torch.from_numpy(x)
    y, _ = moe.apply_moe(cfg, params, xt, DTypePolicy(), mesh=mesh, decode=True)
    x2 = xt.reshape(64, 64)
    gates, experts, _ = moe._route(cfg, params, x2)
    pos = moe._positions_in_expert(experts, 64)
    cap = min(2 * 64, max(32, 8 * -(-2 * 64 // 64)))
    assert cap == 32 and int(pos.max()) >= cap
    kept = torch.where(pos < cap, gates, torch.zeros_like(gates))
    weight = torch.zeros((64, 64)).scatter_(1, experts.long(), kept)
    cdt = torch.bfloat16
    xc = x2.to(cdt)
    h = layers.silu(torch.einsum("td,edf->tef", xc, params["w_gate"].to(cdt))) * \
        torch.einsum("td,edf->tef", xc, params["w_in"].to(cdt))
    plain = torch.einsum("ted,te->td", torch.einsum("tef,efd->ted", h, params["w_out"].to(cdt)),
                         weight.to(cdt)) + layers.apply_mlp(cfg, params["shared"], x2,
                                                            DTypePolicy())
    np.testing.assert_allclose(y.reshape(64, 64).float().numpy(), plain.float().numpy(), **EP)
    dense, _ = moe.dense_moe(cfg, params, xt, DTypePolicy())
    assert float((y.float() - dense.float()).abs().max()) > 0.1  # the dropped tokens


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b", SCOUT])
def test_train_step_on_a_mesh_of_one_equals_the_single_device_step(mesh1, arch):
    """``make_train_step(mesh=)`` on the gloo world of 1 against
    ``make_train_step()`` from the same state: two steps with bit-equal
    params, moments and metrics where no layer changes path (qwen3,
    falcon-mamba); llama4-scout's MoE layers take ``ep_moe`` there
    (``dense_moe`` without a mesh), so its one step's metrics are held at
    1e-4 relative (3.2e-5 here) and its params at 2.05 learning rates (a
    first Adam step may flip where a gradient is near 0).  Its smoke model
    is chaotic past one step (grad_norm 200; the JAX package's own mesh and
    no-mesh second-step losses differ by 3.1e-4)."""
    mesh, _ = mesh1
    cfg = configs.get_smoke_config(arch)
    model = tmodel.build(cfg)
    oc = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    weights = init_numpy(model.specs, seed=0)
    runs = {}
    for on in (False, True):
        state = {"params": tmodel.params_from_numpy(
                     model.specs, T.tree_map(np.copy, weights), "cpu"),
                 "opt": init_params(train_step.state_specs(model, oc)["opt"], torch.Generator(),
                                    "cpu")}
        step = train_step.make_train_step(model, oc, mesh=mesh if on else None)
        ms = []
        for i in range(2 if arch != SCOUT else 1):
            batch = data.device_batch_at(data.DataConfig(cfg.vocab_size, 16, 2, seed=1), i,
                                         mesh=mesh if on else None, device="cpu")
            state, m = step(state, batch)
            ms.append({k: float(v) for k, v in m.items()})
        runs[on] = (T.to_numpy(state), ms)
    (plain, pm), (meshed, mm) = runs[False], runs[True]
    exact = arch != SCOUT
    for a, b in zip(pm, mm):
        for k in a:
            assert (a[k] == b[k]) if exact else abs(a[k] - b[k]) <= LOSS_RTOL * abs(a[k]) + 1e-9, \
                (k, a[k], b[k])
    for (path, a), (_, b) in zip(T.leaves(plain), T.leaves(meshed)):
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=path)
        elif path.startswith("/params/"):
            assert np.abs(a - b).max() <= 2.05 * 1e-3, path


# ---------------------------------------------------------------------------
# tensor parallelism over 'model': the run and held layouts are the specs'


def _named_axes(pspec):
    return {a for e in pspec for a in ((e,) if isinstance(e, str) else (e or ()))}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_and_held_layouts_are_the_specs_over_the_mesh(arch, tp):
    """On a (data, model) = (2, tp) mesh, every leaf of the smoke config
    built at ``tp``: ``run_pspecs`` and ``state_shardings``' params are its
    spec's pspec filtered to the mesh (the MoE layers' expert-parallel
    blocks are their specs' too), the moments its ZeRO-1 pspec (an int8
    moment's scale that without its last axis); and no leaf whose spec
    names 'model' is whole on a rank: its block, cut by ``common.shard``,
    is smaller than the leaf by the 'model' size along that dim."""
    from repro_torch.common import entry_axes, filter_pspec, shard
    from torch_parity import StandInMesh

    model = tmodel.build(configs.get_smoke_config(arch), tp=tp)
    specs = dict(T.leaves(model.specs))
    for coord in ((0, 0), (1, tp - 1)):
        mesh = StandInMesh((2, tp), ("data", "model"), coord)
        run = dict(T.leaves(tmodel.run_pspecs(model, mesh)))
        for mdt in (torch.float32, torch.int8):
            oc = optimizer.OptConfig(moments_dtype=mdt)
            held = train_step.state_shardings(model, oc, mesh)
            params = dict(T.leaves(held["params"]))
            for path, s in specs.items():
                want = filter_pspec(s.pspec, mesh)
                assert run[path] == want and params[path].spec == want, (path, run[path])
            zp = {p: filter_pspec(optimizer.zero1_pspec(s), mesh) for p, s in specs.items()}
            for name in ("m", "v"):
                for path, sh in T.leaves(held["opt"][name]):
                    if mdt == torch.int8:
                        leaf, part = path.rsplit("/", 1)
                        want = zp[leaf] if part == "q" else P(*zp[leaf][:len(specs[leaf].shape) - 1])
                    else:
                        want = zp[path]
                    assert sh.spec == want, (name, path, sh.spec, want)
        for path, s in specs.items():
            block = shard(torch.empty(s.shape, dtype=torch.bfloat16), train_step.NamedSharding(
                mesh, run[path]))
            for i, e in enumerate(s.pspec):
                if "model" in entry_axes(e):
                    assert block.shape[i] * tp == s.shape[i], (path, block.shape, s.shape)
            assert ("model" in _named_axes(s.pspec)) == ("model" in _named_axes(run[path])), path


def test_shard_refuses_a_block_that_does_not_divide():
    """qwen3-1.7b's smoke config at tp = 3: ``mlp_specs`` puts 'model' on
    d_ff = 128, which 3 does not divide, so ``common.shard`` refuses it as
    ``jax.device_put`` does (so do llama4-scout's 4 experts); with d_ff =
    192 every leaf places (its 4 heads pad to 6, F8; its 2 kv heads and its
    vocab of 512 stay whole)."""
    from repro_torch.common import named, shard
    from torch_parity import StandInMesh

    mesh = StandInMesh((1, 3), ("data", "model"), (0, 1))
    cfg = configs.get_smoke_config("qwen3-1.7b")
    w_in = tmodel.build(cfg, tp=3).specs["layers"]["mlp"]["w_in"]
    with pytest.raises(ValueError, match="should be divisible by 3, but it is equal to 128"):
        shard(torch.zeros(w_in.shape), named(mesh, w_in.pspec))
    experts = tmodel.build(configs.get_smoke_config(SCOUT), tp=3).specs["layers"]["moe"]["w_in"]
    with pytest.raises(ValueError, match="should be divisible by 3, but it is equal to 4"):
        shard(torch.zeros(experts.shape), named(mesh, experts.pspec))
    model = tmodel.build(dataclasses.replace(cfg, d_ff=192), tp=3)
    run = dict(T.leaves(tmodel.run_pspecs(model, mesh)))
    for path, s in T.leaves(model.specs):
        block = shard(torch.zeros(s.shape), named(mesh, run[path]))
        assert block.numel() * ("model" in _named_axes(run[path]) and 3 or 1) == \
            torch.Size(s.shape).numel(), path
    assert model.specs["layers"]["attn"]["wq"].shape[2] == 6
    assert "model" not in _named_axes(run["/layers/attn/wk"]) | _named_axes(run["/embed/table"])


FAMILIES = ["qwen3-1.7b", "kimi-k2-1t-a32b", "qwen2-vl-72b", "falcon-mamba-7b", "zamba2-2.7b",
            "whisper-tiny"]


def _count_model_collectives(monkeypatch):
    """A dict {"issued": n, "skipped": n} that counts the collectives over
    'model' (alone or with other axes) until it is cleared:
    ``launch.mesh._skip``, the check every collective makes first, wrapped."""
    counts, skip = {"issued": 0, "skipped": 0}, M._skip

    def counted(op, mesh, axes):
        one = skip(op, mesh, axes)
        if "model" in M._axes(axes):
            counts["skipped" if one else "issued"] += 1
        return one

    monkeypatch.setattr(M, "_skip", counted)
    return counts


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_of_one_serves_bit_equal_and_skips_its_collectives(mesh1, arch, monkeypatch):
    """On the (1, 1) gloo world every weight is its one 'model' block: the
    prefill's and a decode step's logits are bit-equal to the single-device
    run's (kimi-k2's MoE layers take ``ep_moe`` there, ``dense_moe`` without
    a mesh: held at 2e-2), and every collective over 'model' the tensor
    parallel code calls is skipped (``launch.mesh._skip`` counted): none
    is issued."""
    from repro_torch.serve.serve_step import _pad_seq, decode_batch

    mesh, _ = mesh1
    cfg = configs.get_smoke_config(arch)
    model = tmodel.build(cfg)
    params = tmodel.params_from_numpy(model.specs, init_numpy(model.specs, seed=0), "cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["enc_feats"] = torch.from_numpy(
            rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    outs, counting = {}, _count_model_collectives(monkeypatch)
    for m in (None, mesh):
        counting.update(issued=0, skipped=0)
        cache, lg = model.prefill(params, batch, mesh=m)
        cache = _pad_seq(cfg, cache, 8, 2, 9)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        lg2, _ = model.decode_step(params, cache, decode_batch(cfg, tok, 8), 8, mesh=m)
        outs[m is not None] = (lg, lg2, dict(counting))
    (a, a2, none), (b, b2, counts) = outs[False], outs[True]
    assert none == {"issued": 0, "skipped": 0}
    assert counts["issued"] == 0 and counts["skipped"] > 0, counts
    if cfg.family == "moe":
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), **EP)
        np.testing.assert_allclose(b2.float().numpy(), a2.float().numpy(), **EP)
    else:
        assert torch.equal(a, b) and torch.equal(a2, b2)
