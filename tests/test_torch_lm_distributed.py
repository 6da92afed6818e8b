"""The port's LM mesh paths on ``torch.distributed`` against the JAX package's:
one JAX subprocess with 8 fake devices (``conftest.run_with_devices``)
writes every target to an ``.npz``, then two gloo worlds of CPU processes
(``torch_parity.run_torch_world``) run the same inputs.

- A world of 8 on (pod, data, model) = (2, 2, 2): ``apply_moe(mesh=)`` on
  tests/test_distributed.py:12-38's input (kimi-k2's smoke block at
  d_model 64, 8 experts over 'model'), prefill (``ep_moe``) and decode
  (``ep_moe_decode``) shapes, ``fsdp`` False and True, against the JAX
  package's ``shard_map`` on the same mesh and against ``dense_moe``;
  ``ep_moe``'s gradients against ``dense_moe``'s; and
  ``common.shard`` blocks equal to ``jax.device_put``'s addressable shards
  for partition specs with tuple entries, ``unshard`` giving the global
  array back.
- A world of 4 on (data, model) = (2, 2): ``ep_moe_decode`` on
  tests/test_perf_paths.py:51-78's input; two steps of
  ``make_train_step(mesh=)`` on qwen3-1.7b's smoke config (once with
  ``accum_steps=2``) and on kimi-k2's with int8 moments, from the state
  placed by ``state_shardings``, against the JAX package's
  ``jit(make_train_step(model, oc, mesh=mesh))`` from the state placed by
  ``shardings``: params, moments, step and metrics; ``device_batch_at(mesh=)``
  blocks equal to the JAX package's addressable shards; and
  ``restore(shardings=)`` of a checkpoint saved from a (4, 1) layout onto
  (2, 2) (tests/test_distributed.py:102-124's array).

Tolerances, each set from the JAX package's own distance between its mesh
and no-mesh results on the same input (jax 0.9, torch 2.13, on a CPU):
- MoE outputs at 2e-2 (rtol and atol), the JAX package's own bound in
  tests/test_distributed.py and tests/test_perf_paths.py (its mesh and
  ``dense_moe`` outputs are 0.0156 apart on the prefill input); the port's
  are at most 0.0156 from the JAX package's here.  aux is float32: rtol
  1e-5.
- Train steps (``HELD``): twice the JAX package's own mesh-vs-no-mesh
  distance after the same step.  qwen3: loss and ce 2.6e-5 relative,
  grad_norm 6.9e-4; params at most 2.0 and 3.2 learning rates apart after
  steps 1 and 2 (an Adam step moves a param by about lr, and one whose
  gradient is near 0 may step the other way), 0.35% of them past half a
  learning rate; 0.003% of moment entries past 2e-2 of their leaf's
  largest.  The port against the JAX package: 2.5e-5, 7.4e-4, 2.0 and 3.4
  lr, 0.33%, 0.002%.  kimi-k2 (its MoE routes a token to another expert on
  a rounding, which moves that expert's gradient rows whole): after step
  1, loss 4.9e-4, aux 2.9e-3, grad_norm 6.7e-3, params 2.0 lr with 4.6%
  past half a learning rate, 9.3% of moment entries past 2e-2 (the port:
  6.4e-4, 2.5e-4, 8.5e-3, 2.0 lr, 4.6%, 7.9%); at step 2, loss 2.7e-3,
  aux 9.2e-3 and grad_norm 0.43 (the port: 3.0e-3, 2.4e-3, 0.21).  Its
  state after step 2 is not held: its int8 v rounds a row's small entries
  to 0 (ROADMAP F5), so where the second batch leaves a row's gradient at
  0 the update divides by eps, and which entries do depends on rounding:
  the JAX package's own mesh and no-mesh params are then up to 2.8e5
  learning rates apart, 11% of them past 4.1.
"""
import re

import numpy as np
import pytest

from conftest import run_with_devices
from torch_parity import run_torch_world

SEQ, BATCH = 16, 8  # the train steps' DataConfig
TRAIN = [("qwen3-1.7b", "float32", 1), ("qwen3-1.7b", "float32", 2),
         ("kimi-k2-1t-a32b", "int8", 1)]
MOE_CASES = [(fsdp, dec) for fsdp in (0, 1) for dec in (0, 1)]
LAYOUTS = [(("data", "pod"), None, "model"), ("model", ("pod", "data")), (None, "data")]

JAX_SIDE = '''
import dataclasses, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.common import DTypePolicy, init_params, shardings
from repro.configs import get_smoke_config
from repro.models.moe import apply_moe, moe_specs
from repro.models.model import build
from repro.train import data, optimizer as opt, train_step as ts
from repro_torch.common import init_numpy
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.models.model import build as port_build

OUT, SEQ, BATCH = sys.argv[1], %(seq)d, %(batch)d
TRAIN, LAYOUTS = %(train)r, %(layouts)r
out = {}
key = lambda k: jax.tree_util.keystr(k)

def blocks(prefix, arr, sharding):
    mesh = sharding.mesh
    for s in jax.device_put(arr, sharding).addressable_shards:
        coord = tuple(int(c) for c in np.argwhere(mesh.devices == s.device)[0])
        out[prefix + ":" + ",".join(map(str, coord))] = np.asarray(s.data)

pol = DTypePolicy()
cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), d_model=64)
params = init_params(jax.random.PRNGKey(0), moe_specs(cfg, tp=2))
for k, v in jax.tree_util.tree_leaves_with_path(params):
    out["moe_params" + key(k)] = np.asarray(v)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 64), jnp.float32)
xd = jax.random.normal(jax.random.PRNGKey(1), (4, 1, 64), jnp.float32)
out["x0"], out["x1"] = np.asarray(x), np.asarray(xd)
out["dense0"] = np.asarray(apply_moe(cfg, params, x, pol)[0], np.float32)
out["dense1"] = np.asarray(apply_moe(cfg, params, xd, pol)[0], np.float32)
mesh8 = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
for fsdp in (0, 1):
    for dec, xx in ((0, x), (1, xd)):
        with compat.set_mesh(mesh8):
            y, aux = jax.jit(lambda p, x: apply_moe(cfg, p, x, pol, mesh=mesh8, fsdp=bool(fsdp),
                                                    decode=bool(dec)))(params, xx)
        out[f"ep8_{fsdp}{dec}"], out[f"aux8_{fsdp}{dec}"] = np.asarray(y, np.float32), np.asarray(aux)
arr = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
for i, layout in enumerate(LAYOUTS):
    blocks(f"layout{i}", arr, NamedSharding(mesh8, P(*layout)))

mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with compat.set_mesh(mesh4):
    y, aux = jax.jit(lambda p, x: apply_moe(cfg, p, x, pol, mesh=mesh4, decode=True))(params, xd)
out["ep4_dec"], out["aux4_dec"] = np.asarray(y, np.float32), np.asarray(aux)
for arch, mdt, accum in TRAIN:
    jcfg = get_smoke_config(arch)
    model = build(jcfg, tp=2)
    weights = init_numpy(port_build(port_smoke_config(arch), tp=2).specs, seed=0)
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=100, moments_dtype=getattr(jnp, mdt))
    state = {"params": jax.tree.map(jnp.asarray, weights),
             "opt": init_params(jax.random.PRNGKey(0), opt.opt_specs(model.specs, oc))}
    state = jax.device_put(state, shardings(ts.state_specs(model, oc), mesh4))
    dc = data.DataConfig(jcfg.vocab_size, SEQ, BATCH, seed=0)
    name = f"train_{arch}_{accum}"
    with compat.set_mesh(mesh4):
        step = jax.jit(ts.make_train_step(model, oc, accum_steps=accum, mesh=mesh4))
        for i in range(2):
            state, m = step(state, data.device_batch_at(dc, i, mesh=mesh4))
            for k, v in m.items():
                out[f"{name}:m{i}/{k}"] = np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(state):
                out[f"{name}@{i}" + key(k)] = np.asarray(v)
dc = data.DataConfig(512, SEQ, BATCH, seed=3)
for k, v in data.device_batch_at(dc, 5, mesh=mesh4).items():
    for s in v.addressable_shards:
        coord = tuple(int(c) for c in np.argwhere(mesh4.devices == s.device)[0])
        out[f"batch/{k}:" + ",".join(map(str, coord))] = np.asarray(s.data)
np.savez(os.path.join(OUT, "jax.npz"), **out)
'''

TORCH_SIDE = '''
import dataclasses, os, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import tree as T
from repro_torch.common import (DTypePolicy, P, ParamSpec, init_numpy, init_params, named,
                                shard, unshard)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.models import moe
from repro_torch.models.layers import batch_pspec
from repro_torch.models.model import build, params_from_numpy
from repro_torch.train import checkpoint as ckpt, data, optimizer as opt, train_step as ts

SEQ, BATCH = %(seq)d, %(batch)d
TRAIN, LAYOUTS = %(train)r, %(layouts)r
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
M.init_world(os.environ["INIT_METHOD"], rank, world, device="cpu", timeout_s=120)
j = dict(np.load(os.path.join(os.environ["OUT"], "jax.npz")))
out = {}
pol = DTypePolicy()
cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), d_model=64)
params = {}
for k, v in j.items():
    if k.startswith("moe_params"):
        path = [p.strip("'") for p in k[len("moe_params["):-1].split("][")]
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.from_numpy(v)

def ep_run(mesh, fsdp, dec):
    pspecs = moe.ep_pspecs(cfg, bool(fsdp))
    local = T.tree_map(lambda x, ps: shard(x, named(mesh, ps)), params, pspecs)
    bs = named(mesh, batch_pspec(None, None))
    y, aux = moe.apply_moe(cfg, local, shard(torch.from_numpy(j[f"x{dec}"]), bs), pol,
                           mesh=mesh, fsdp=bool(fsdp), decode=bool(dec))
    return unshard(y, bs).float().numpy(), float(aux)

def ep_grads(mesh, fsdp):
    """d/dparams of sum(y * w) / tp on each rank (its batch block, the
    model ranks' copies counted once), summed over the axes a leaf's block
    is not split on and gathered: the gradient of sum(y * w) over the whole
    batch, through the collectives' backward passes."""
    pspecs = moe.ep_pspecs(cfg, bool(fsdp))
    local = T.tree_map(lambda x, ps: shard(x, named(mesh, ps)).requires_grad_(True), params,
                       pspecs)
    bs = named(mesh, batch_pspec(None, None))
    y, _ = moe.apply_moe(cfg, local, shard(torch.from_numpy(j["x0"]), bs), pol, mesh=mesh,
                         fsdp=bool(fsdp))
    loss = (y.float() * shard(WEIGHT, bs)).sum() / M.axis_size(mesh, "model")
    paths, leaves = zip(*T.leaves(local))
    specs = dict(T.leaves(pspecs))
    for path, g in zip(paths, torch.autograd.grad(loss, leaves)):
        used = {a for e in specs[path] if e is not None for a in ((e,) if isinstance(e, str) else e)}
        rest = tuple(a for a in mesh.mesh_dim_names if a not in used)
        g = M.all_reduce(g, mesh, rest) if rest else g
        out[f"grad8_{fsdp}{path}"] = unshard(g, named(mesh, specs[path])).numpy()

WEIGHT = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 16, 64)).astype(np.float32))
if world == 8:
    mesh8 = M.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    for fsdp in (0, 1):
        for dec in (0, 1):
            y, aux = ep_run(mesh8, fsdp, dec)
            out[f"ep8_{fsdp}{dec}"], out[f"aux8_{fsdp}{dec}"] = y, np.array(aux, np.float32)
        ep_grads(mesh8, fsdp)
    dense = T.tree_map(lambda x: x.clone().requires_grad_(True), params)
    y, _ = moe.dense_moe(cfg, dense, torch.from_numpy(j["x0"]), pol)
    paths, leaves = zip(*T.leaves(dense))
    for path, g in zip(paths, torch.autograd.grad((y.float() * WEIGHT).sum(), leaves)):
        out[f"grad_dense{path}"] = g.numpy()
    arr = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    here = ",".join(map(str, mesh8.get_coordinate()))
    for i, layout in enumerate(LAYOUTS):
        blk = shard(arr, named(mesh8, P(*layout)))
        out[f"layout{i}:{here}"] = blk.numpy()
        out[f"layout{i}:global"] = unshard(blk, named(mesh8, P(*layout))).numpy()
else:
    mesh = M.make_test_mesh(2, 2, device="cpu")
    here = ",".join(map(str, mesh.get_coordinate()))
    y, aux = ep_run(mesh, 0, 1)
    out["ep4_dec"], out["aux4_dec"] = y, np.array(aux, np.float32)
    for arch, mdt, accum in TRAIN:
        model = build(get_smoke_config(arch), tp=2)
        oc = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=100,
                           moments_dtype=getattr(torch, mdt))
        state = {"params": params_from_numpy(model.specs, init_numpy(model.specs, seed=0), "cpu"),
                 "opt": init_params(ts.state_specs(model, oc)["opt"], torch.Generator(), "cpu")}
        sh = ts.state_shardings(model, oc, mesh)
        state = T.tree_map(shard, state, sh)
        step = ts.make_train_step(model, oc, accum_steps=accum, mesh=mesh)
        dc = data.DataConfig(model.cfg.vocab_size, SEQ, BATCH, seed=0)
        name = f"train_{arch}_{accum}"
        for i in range(2):
            state, m = step(state, data.device_batch_at(dc, i, mesh=mesh, device="cpu"))
            for k, v in m.items():
                out[f"{name}:m{i}/{k}"] = v.numpy()
            for path, x in T.leaves(T.tree_map(unshard, state, sh)):
                out[f"{name}@{i}{path}"] = x.numpy().copy()  # the state moves on in place
    dc = data.DataConfig(512, SEQ, BATCH, seed=3)
    for k, v in data.device_batch_at(dc, 5, mesh=mesh, device="cpu").items():
        out[f"batch/{k}:{here}"] = v.numpy()
    # a checkpoint saved from a (4, 1) layout, restored onto (2, 2)
    x = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    four = M.make_mesh((4, 1), ("data", "model"), device="cpu")
    saved = ckpt.save(os.path.join(os.environ["OUT"], "ckpt"), 5,
                      {"w": shard(x, named(four, P("data", "model")))},
                      shardings={"w": named(four, P("data", "model"))})
    back, at = ckpt.restore(os.path.join(os.environ["OUT"], "ckpt"), {"w": ParamSpec((64, 8))},
                            shardings={"w": named(mesh, P("data", "model"))})
    out["restore:step"] = np.array(at)
    out["restore:block_equal"] = np.array(
        torch.equal(back["w"], shard(x, named(mesh, P("data", "model")))))
    out["restore:global_equal"] = np.array(torch.equal(unshard(back["w"], named(
        mesh, P("data", "model"))), x))
    out["restore:block_shape"] = np.array(back["w"].shape)
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
dist.destroy_process_group()
'''

_FILL = dict(seq=SEQ, batch=BATCH, train=TRAIN, layouts=LAYOUTS)
MOE_TOL = dict(rtol=2e-2, atol=2e-2)
LR = 1e-3
# the bounds the train steps are held to after each step, each twice the JAX
# package's own distance between its mesh and no-mesh steps on the same
# input (rounded up; the module's docstring): metrics relative, params in
# learning rates (the largest gap, and the share past half a learning
# rate), moments by the share of entries past 2e-2 of their leaf's largest
HELD = {
    "qwen3-1.7b": [dict(loss=6e-5, ce=6e-5, grad_norm=2e-3, lr_max=2.05, lr_share=7e-3,
                        mom_share=6e-5),
                   dict(loss=6e-5, ce=6e-5, grad_norm=2e-3, lr_max=4.1, lr_share=7e-3,
                        mom_share=6e-5)],
    "kimi-k2-1t-a32b": [dict(loss=1e-3, ce=1e-3, aux=6e-3, grad_norm=1.4e-2, lr_max=2.05,
                             lr_share=0.1, mom_share=0.2),
                        dict(loss=6e-3, ce=6e-3, aux=2e-2, grad_norm=0.9)],
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"jax": the JAX package's arrays, 8: {rank: arrays}, 4: {rank: arrays}}."""
    jdir = tmp_path_factory.mktemp("lm_jax")
    run_with_devices((JAX_SIDE % _FILL).replace("sys.argv[1]", repr(str(jdir))), n_devices=8,
                     timeout=600)
    got = {"jax": dict(np.load(jdir / "jax.npz"))}
    for world in (8, 4):
        wdir = tmp_path_factory.mktemp(f"lm_world{world}")
        (wdir / "jax.npz").symlink_to(jdir / "jax.npz")
        run_torch_world(TORCH_SIDE % _FILL, world, wdir, timeout=300)
        got[world] = {r: dict(np.load(wdir / f"rank{r}.npz")) for r in range(world)}
    return got


@pytest.mark.parametrize("fsdp,dec", MOE_CASES)
def test_ep_moe_world_of_8_matches_jax(results, fsdp, dec):
    """(pod, data, model) = (2, 2, 2): the global output (every rank's block
    all-gathered) equal on all ranks, within the tolerance of the JAX
    package's ``shard_map`` and of ``dense_moe``; aux equal on all ranks."""
    want, dense = results["jax"][f"ep8_{fsdp}{dec}"], results["jax"][f"dense{dec}"]
    for r, got in results[8].items():
        y = got[f"ep8_{fsdp}{dec}"]
        np.testing.assert_allclose(y, want, **MOE_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(y, dense, **MOE_TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(y, results[8][0][f"ep8_{fsdp}{dec}"])
        np.testing.assert_allclose(got[f"aux8_{fsdp}{dec}"], results["jax"][f"aux8_{fsdp}{dec}"],
                                   rtol=1e-5)


@pytest.mark.parametrize("fsdp", [0, 1])
def test_ep_moe_gradients_world_of_8_match_dense(results, fsdp):
    """The gradient of ``sum(y * w)`` through ``ep_moe`` on (2, 2, 2), each
    rank differentiating its own block through the collectives' backward
    passes (``psum``'s a ``psum``, with ``fsdp`` ``all_gather``'s a
    reduce-scatter), summed over the axes a block is not split on: within
    2e-2 of each leaf's largest of ``dense_moe``'s gradient (the port's are
    3.8e-3 of it apart here, the JAX package's own ``ep_moe`` gradients
    4.8e-3 from its ``dense_moe``'s on a (2, 2) mesh), equal on every
    rank."""
    dense = {k[len("grad_dense"):]: v for k, v in results[8][0].items()
             if k.startswith("grad_dense")}
    assert sorted(dense) == ["/router", "/shared/w_gate", "/shared/w_in", "/shared/w_out",
                             "/w_gate", "/w_in", "/w_out"]
    for r, got in results[8].items():
        for path, want in dense.items():
            g = got[f"grad8_{fsdp}{path}"]
            assert g.shape == want.shape
            err = np.abs(g - want).max() / np.abs(want).max()
            assert err <= 2e-2, (r, path, err)
            np.testing.assert_array_equal(g, results[8][0][f"grad8_{fsdp}{path}"])


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_shard_blocks_equal_jax_addressable_shards(results, layout):
    """``common.shard``'s block on each rank is the JAX package's addressable
    shard at the same mesh coordinate (a tuple entry's first axis the major
    one), and ``unshard`` gives the global array back."""
    arr = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    for r, got in results[8].items():
        (key,) = [k for k in got if k.startswith(f"layout{layout}:") and not k.endswith("global")]
        np.testing.assert_array_equal(got[key], results["jax"][key], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[f"layout{layout}:global"], arr)


def test_ep_moe_decode_world_of_4_matches_jax(results):
    """(data, model) = (2, 2), tests/test_perf_paths.py's decode input."""
    for r, got in results[4].items():
        np.testing.assert_allclose(got["ep4_dec"], results["jax"]["ep4_dec"], **MOE_TOL)
        np.testing.assert_allclose(got["ep4_dec"], results["jax"]["dense1"], **MOE_TOL)
        np.testing.assert_allclose(got["aux4_dec"], results["jax"]["aux4_dec"], rtol=1e-5)


def _port_path(keystr):
    """The JAX package's keystr (['a']['b']) as a port tree path (/a/b)."""
    return "".join(f"/{k}" for k in re.findall(r"\['([^']*)'\]", keystr))


def _moments(arrays):
    """{path: (float32 moment, quantization step or None)}: an int8 moment
    dequantized (q * scale), its step the row's scale."""
    out = {}
    for k, v in arrays.items():
        if k.endswith("/q"):
            scale = arrays[k[:-2] + "/scale"][..., None]
            out[k[:-2]] = (v.astype(np.float32) * scale, scale)
        elif not k.endswith("/scale"):
            out[k] = (v, None)
    return out


@pytest.mark.parametrize("case", range(len(TRAIN)))
def test_train_step_over_a_mesh_matches_jax(results, case):
    """Two steps of ``make_train_step(mesh=)`` on (data, model) = (2, 2),
    against the JAX package's jitted mesh step after each: the metrics, and
    the params and moments after each step HELD gives bounds for (the
    module's docstring says why kimi-k2's state after its second step is
    not), on every rank, with the step counter."""
    arch, mdt, accum = TRAIN[case]
    name = f"train_{arch}_{accum}"
    j = results["jax"]
    for i, held in enumerate(HELD[arch]):
        pre = f"{name}@{i}"
        want = _moments({_port_path(k[len(pre):]): v for k, v in j.items()
                         if k.startswith(pre + "[")})
        for r, got in results[4].items():
            for k in ("loss", "ce", "aux", "grad_norm"):
                w, g = float(j[f"{name}:m{i}/{k}"]), float(got[f"{name}:m{i}/{k}"])
                assert abs(g - w) <= held.get(k, 0.0) * abs(w), (r, i, k, g, w)
            assert float(got[f"{name}:m{i}/lr"]) == float(j[f"{name}:m{i}/lr"])
            have = _moments({k[len(pre):]: v for k, v in got.items() if k.startswith(pre + "/")})
            assert sorted(have) == sorted(want) and int(have["/opt/step"][0]) == i + 1
            assert all(np.isfinite(v).all() for v, _ in have.values())
            if "lr_max" not in held:
                continue
            params = [k for k in have if k.startswith("/params/")]
            d = np.concatenate([np.abs(have[k][0] - want[k][0]).ravel() / LR for k in params])
            assert d.max() <= held["lr_max"] and np.mean(d > 0.5) <= held["lr_share"], \
                (r, i, float(d.max()), float(np.mean(d > 0.5)))
            moms = [k for k in have if k.startswith(("/opt/m/", "/opt/v/"))]
            assert any(have[k][1] is not None for k in moms) == (mdt == "int8")
            md = np.concatenate([(np.abs(have[k][0] - want[k][0])
                                  / (np.abs(want[k][0]).max() + 1e-30)).ravel() for k in moms])
            assert np.mean(md > 2e-2) <= held["mom_share"], (r, i, float(np.mean(md > 2e-2)))


def test_device_batch_at_blocks_equal_jax_shards(results):
    for r, got in results[4].items():
        keys = [k for k in got if k.startswith("batch/")]
        assert keys and all(k.split(":")[0] in ("batch/tokens",) for k in keys)
        for k in keys:
            np.testing.assert_array_equal(got[k], results["jax"][k], err_msg=f"rank {r} {k}")


def test_restore_onto_another_mesh(results):
    """Saved from the (4, 1) layout (rank 0 writes the gathered array),
    restored onto (2, 2): each rank holds its (32, 4) block, and the blocks
    gather to the saved array."""
    for r, got in results[4].items():
        assert int(got["restore:step"]) == 5
        assert bool(got["restore:block_equal"]) and bool(got["restore:global_equal"])
        assert got["restore:block_shape"].tolist() == [32, 4]
