"""The two sides of the tensor-parallel parity tests (tests/test_torch_tp.py,
tests/test_torch_tp_train.py): the same numpy weights (``common.init_numpy``)
and inputs through the JAX package's jitted steps over a mesh of fake
devices, as ``launch/dryrun.py`` lowers them (``in_shardings`` of the
specs' shardings, the batch over 'data'), and through the port's steps on
its blocks in a gloo world of CPU processes.

A serving case is ``name: (arch, (data, model), config overrides[,
options])``: the prefill's last-position logits and three decode steps'
logits, each step fed the JAX package's greedy token (teacher forcing),
the JAX package's greedy tokens and top-1/top-2 margins, and the port's
own greedy tokens (``greedy_generate(mesh=)``); ``Model.loss`` where the
case asks for it.  The options: ``batch`` (B unless given), ``pad_to``
(S + STEPS unless given; None: the prompt's length, the reference's
clamped write) and ``split_kv``: the JAX package's decode step jitted as
``launch/dryrun.py`` jits it, the cache placed and returned in
``cache_specs``' shardings at the cache's global batch and length, and
every step's cache kept on both sides (the port's gathered from its
blocks, with each block's shape checked against its pspec).
A train case is ``name: (arch, (data, model), config overrides)``: two
steps of ``make_train_step(mesh=)``, metrics and the whole state after
each.  With ``measure`` the JAX side also runs every case without a mesh
(serving fed the mesh run's tokens), the distances the tests' bounds are
set from.

The port's side also runs every case in float32 compute (the model's
``DTypePolicy`` with ``compute=float32``) on the mesh and on one device
(the whole weights, the whole batch, no mesh): the fed logits of both, and
for a train case the loss and every leaf's gradient, the mesh's reduced to
its gradient block by the step's own ``_reduce_grad`` and gathered.  Without
bf16 rounding between them the two agree to float32's, so a fault in the
tensor-parallel arithmetic shows there however loose the bf16 bounds
against the JAX package must be.
"""
import math

import numpy as np

from conftest import run_with_devices
from torch_parity import run_torch_world

B, S, STEPS = 4, 16, 4  # batch, prompt, greedy tokens (the prefill's and 3 decode steps')
N_VISION, FRAMES = 8, 64

_COMMON = '''
import dataclasses, os, sys
import numpy as np
B, S, STEPS, N_VISION, FRAMES = %(b)d, %(s)d, %(steps)d, %(nv)d, %(frames)d
SERVE, TRAIN, LOSS, MEASURE, CHECKS = %(serve)r, %(train)r, %(loss)r, %(measure)r, %(checks)r

def case_of(case):
    """(arch, shape, overrides, batch, pad_to, split_kv) of a serving case."""
    arch, shape, over = case[:3]
    opts = case[3] if len(case) > 3 else {}
    return (arch, tuple(shape), over, opts.get("batch", B), opts.get("pad_to", S + STEPS),
            opts.get("split_kv", False))
'''

JAX_SIDE = _COMMON + '''
import contextlib
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.common import init_params, shardings
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.models.model import build, cache_specs, input_specs
from repro.serve.serve_step import cache_seq_axes
from repro.train import data, optimizer as opt, train_step as ts
from repro_torch.common import init_numpy
from repro_torch.configs import get_smoke_config as port_config
from repro_torch.models.model import build as port_build

OUT = sys.argv[1]
out = {}

def jparams(w):
    return jax.tree.map(lambda x: jnp.asarray(x).view(jnp.bfloat16) if x.dtype == np.uint16
                        else jnp.asarray(x), w)

def positions(seq, b):
    """Qwen2-VL's M-RoPE positions: the patches on a (2, 2, 2) grid, the text after."""
    tt, hh, ww = np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij")
    vis = np.stack([tt.ravel(), hh.ravel(), ww.ravel()])
    text = np.arange(seq - vis.shape[1]) + vis.max() + 1
    pos = np.concatenate([vis, np.broadcast_to(text, (3, seq - vis.shape[1]))], axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, seq))).astype(np.int32)

def make_batch(cfg, b):
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(0, 1, (b, N_VISION, cfg.d_model)).astype(np.float32)
        out["mrope_pos"] = positions(S, b)
    if cfg.family == "encdec":
        out["enc_feats"] = rng.normal(0, 1, (b, FRAMES, cfg.d_model)).astype(np.float32)
    return out

def pad(cfg, cache, b, pad_to):
    """greedy_generate(pad_to=)'s padding, on the host (the prefill's
    output layouts are GSPMD's; the decode step places the cache anew)."""
    cache = jax.tree.map(np.asarray, cache)
    flat, treedef = jax.tree.flatten(cache)
    axes = cache_seq_axes(cfg, cache, S, b)
    def one(x, ax):
        if ax is None or pad_to is None:
            return x
        width = [(0, 0)] * x.ndim
        width[ax] = (0, pad_to - x.shape[ax])
        return np.pad(x, width)
    return jax.tree.unflatten(treedef, [one(x, ax) for x, ax in zip(flat, axes)])

def on_mesh(mesh, ps):
    """NamedSharding of ``ps`` with the axes ``mesh`` lacks dropped."""
    names = set(mesh.axis_names)
    def f(e):
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a in names)
            return kept if kept else None
        return e if e in names else None
    return NamedSharding(mesh, P(*(f(e) for e in ps)))

def serve(model, params, jb, mesh, feed=None, b=B, pad_to=S + STEPS, split=False):
    """(logits (B, STEPS, V) float32, tokens, margins, caches): greedy, or
    fed ``feed``.  With ``split`` (and a mesh) the decode step is jitted as
    launch/dryrun.py jits it, its cache in ``cache_specs``' shardings;
    ``caches`` is the padded prefill's cache and every decode step's (host
    leaves) where ``split``."""
    cfg = model.cfg
    with compat.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        prefill = jax.jit(lambda p, b: model.prefill(p, b, mesh=mesh))
        fn = lambda p, c, b, pos: model.decode_step(p, c, b, pos, mesh=mesh)
        cache, lg = prefill(params, jb)
        cache = pad(cfg, cache, b, pad_to)
        caches = [[np.asarray(x) for x in jax.tree.leaves(cache)]] if split else []
        if split and mesh is not None:
            cell = ShapeConfig("decode", pad_to or S, b, "decode")
            csd, cps = cache_specs(cfg, cell, tp=mesh.shape["model"])
            csh = jax.tree.map(lambda ps: on_mesh(mesh, ps), cps,
                               is_leaf=lambda x: isinstance(x, P))
            _, ips = input_specs(cfg, cell)
            ish = {k: on_mesh(mesh, ps) for k, ps in ips.items()}
            step = jax.jit(fn, in_shardings=(shardings(model.specs, mesh), csh, ish, None),
                           out_shardings=(None, csh))
            cache = jax.device_put(cache, csh)
        else:
            step = jax.jit(fn)
        lgs, toks, margins = [], [], []
        for i in range(STEPS):
            last = np.asarray(lg[:, -1], np.float32)
            top2 = np.sort(last, axis=-1)[:, -2:]
            lgs.append(last)
            toks.append(np.argmax(last, axis=-1).astype(np.int32))
            margins.append(top2[:, 1] - top2[:, 0])
            if i < STEPS - 1:
                tok = toks[-1] if feed is None else feed[:, i]
                db = {"tokens": jnp.asarray(tok[:, None])}
                if cfg.mrope:
                    db["mrope_pos"] = jnp.full((3, b, 1), S + i, jnp.int32)
                lg, cache = step(params, cache, db, jnp.int32(S + i))
                if split:
                    caches.append([np.asarray(x) for x in jax.tree.leaves(cache)])
    return np.stack(lgs, 1), np.stack(toks, 1), np.stack(margins, 1), caches

def keep_caches(prefix, caches):
    """``<prefix>/cache<i>/<leaf>``: i = -1 the padded prefill's, then each step's."""
    for i, leaves in enumerate(caches):
        for j, x in enumerate(leaves):
            out[f"{prefix}/cache{i - 1}/{j}"] = x.view(np.uint16) if x.dtype == jnp.bfloat16 else x

meshes = {}
def mesh_of(shape):
    if shape not in meshes:
        n = shape[0] * shape[1]
        meshes[shape] = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    return meshes[shape]

for name, case in SERVE.items():
    arch, shape, over, b, pad_to, split = case_of(case)
    mesh, tp = mesh_of(shape), shape[1]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = build(cfg, tp=tp)
    w = init_numpy(port_build(dataclasses.replace(port_config(arch), **over), tp=tp).specs, seed=0)
    batch = make_batch(cfg, b)
    for k, v in batch.items():
        out[f"{name}/batch/{k}"] = v
    jb = {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in batch.items()}
    placed = jax.device_put(jparams(w), shardings(model.specs, mesh))
    pb = jax.device_put(jb, {k: NamedSharding(mesh, P(None, "data") if k == "mrope_pos"
                                              else P("data")) for k in jb})
    lgs, toks, margins, caches = serve(model, placed, pb, mesh, b=b, pad_to=pad_to, split=split)
    out[f"{name}/logits"], out[f"{name}/tokens"], out[f"{name}/margins"] = lgs, toks, margins
    keep_caches(name, caches)
    if name in LOSS:
        with compat.set_mesh(mesh):
            out[f"{name}/loss"] = np.asarray(
                jax.jit(lambda p, b: model.loss(p, b, mesh=mesh)[0])(placed, pb))
    if MEASURE:
        plain = jparams(w)
        lgs, _, _, caches = serve(model, plain, jb, None, feed=toks, b=b, pad_to=pad_to,
                                  split=split)
        out[f"{name}/plain_logits"] = lgs
        keep_caches(f"{name}/plain", caches)
        if name in LOSS:
            out[f"{name}/plain_loss"] = np.asarray(
                jax.jit(lambda p, b: model.loss(p, b)[0])(plain, jb))

if "f10" in CHECKS:  # ROADMAP F10: a split over 'data' tested against the 'model' size
    cfg = get_smoke_config("qwen3-1.7b")
    csd, cps = cache_specs(cfg, ShapeConfig("p", 18, 4, "decode"), tp=2)
    m = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    leaf, ps = csd["layers"][0], cps["layers"][0]
    out["f10/pspec"] = np.array(str(ps))
    try:
        jax.device_put(jnp.zeros(leaf.shape, leaf.dtype), NamedSharding(m, ps))
        out["f10/message"] = np.array("")
    except ValueError as e:
        out["f10/message"] = np.array(str(e))

key = lambda k: jax.tree_util.keystr(k)
for name, (arch, shape, over) in TRAIN.items():
    mesh, tp = mesh_of(tuple(shape)), shape[1]
    model = build(dataclasses.replace(get_smoke_config(arch), **over), tp=tp)
    weights = init_numpy(port_build(dataclasses.replace(port_config(arch), **over), tp=tp).specs,
                         seed=0)
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    dc = data.DataConfig(model.cfg.vocab_size, S, 8, seed=0)
    runs = [("", mesh)] + ([("plain_", None)] if MEASURE else [])
    for tag, m in runs:
        state = {"params": jax.tree.map(jnp.asarray, weights),
                 "opt": init_params(jax.random.PRNGKey(0), opt.opt_specs(model.specs, oc))}
        if m is not None:
            state = jax.device_put(state, shardings(ts.state_specs(model, oc), m))
            with compat.set_mesh(m):
                step = jax.jit(ts.make_train_step(model, oc, mesh=m))
                batches = [data.device_batch_at(dc, i, mesh=m) for i in range(2)]
                states = []
                for i in range(2):
                    state, met = step(state, batches[i])
                    states.append((state, met))
        else:
            step = jax.jit(ts.make_train_step(model, oc))
            states = []
            for i in range(2):
                state, met = step(state, data.batch_at(dc, i))
                states.append((state, met))
        for i, (st, met) in enumerate(states):
            for k, v in met.items():
                out[f"{tag}train_{name}:m{i}/{k}"] = np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(st):
                out[f"{tag}train_{name}@{i}" + key(k)] = np.asarray(v)
np.savez(os.path.join(OUT, "jax.npz"), **out)
'''

TORCH_SIDE = _COMMON + '''
import functools
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import tree as T
from repro_torch.common import entry_axes, init_numpy, init_params, named, shard, unshard, P
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy, run_pspecs
from repro_torch.serve.serve_step import _pad_seq, decode_batch, decode_layout_of, greedy_generate
from repro_torch.train import data, optimizer as opt, train_step as ts

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
M.init_world(os.environ["INIT_METHOD"], rank, world, device="cpu", timeout_s=180)
j = dict(np.load(os.path.join(os.environ["OUT"], "jax.npz")))
out = {}
meshes = {}

def mesh_of(shape):
    if shape not in meshes:
        meshes[shape] = M.make_mesh(shape, ("data", "model"), device="cpu")
    return meshes[shape]

def layout(name, mesh, tree, pspecs, whole):
    """Each leaf's block against its pspec: its shape, its bytes, and
    whether a leaf whose pspec names 'model' is whole (it must not be)."""
    tp = M.axis_size(mesh, "model")
    blocks, held, full, wrong = 0, 0, 0, []
    for (path, x), (_, ps), (_, g) in zip(T.leaves(tree), T.leaves(pspecs), T.leaves(whole)):
        want = list(g.shape)
        for i, e in enumerate(ps):
            want[i] //= M.axis_size(mesh, entry_axes(e)) if e is not None else 1
        names = {a for e in ps for a in entry_axes(e)}
        if list(x.shape) != want or ("model" in names and tp > 1 and x.shape == g.shape):
            wrong.append(path)
        if not torch.equal(x, shard(g, named(mesh, ps))):
            wrong.append(path + " (values)")
        held += x.numel() * x.element_size()
        full += g.numel() * g.element_size()
    out[f"{name}/bytes"] = np.array([held, full])
    out[f"{name}/wrong"] = np.array(wrong or [""])

def gather_last(cfg, mesh, lg):
    """The whole (B, V) float32 logits from this rank's (b, v) block."""
    if mesh is None:
        return lg.float().numpy()
    split = M.axis_size(mesh, "model") > 1 and lg.shape[-1] < cfg.vocab_size
    return unshard(lg.float(), named(mesh, P("data", "model" if split else None))).numpy()

def cache_blocks(name, cfg, mesh, layout, cache):
    """The whole cache from this rank's blocks (``unshard`` of ``layout``),
    and each attention leaf's block against its pspec: its shape, and
    whether it is whole where the pspec splits it over axes larger than 1
    (it must not be); the sizes the sequence dim is split into."""
    from repro_torch.models.model import attn_cache_keys
    attn = {"/" + "/".join(keys) for keys in attn_cache_keys(cfg)}
    lead = 2 if cfg.family == "hybrid" else 1  # an ssm state: this rank's rows over 'data'
    def gather(path, x):
        ps = dict(T.leaves(layout))[path]
        if not any(path.startswith(a + "/") for a in attn):
            ps = P(*[("data" if i == lead else e) for i, e in enumerate(ps)])
        return unshard(x, named(mesh, ps))
    whole = T.map_with_path(gather, cache)
    wrong, seq = [], []
    for keys in attn_cache_keys(cfg):
        sub = lambda t: functools.reduce(lambda a, k: a[k], keys, t)
        for (path, x), (_, ps), (_, g) in zip(T.leaves(sub(cache)), T.leaves(sub(layout)),
                                              T.leaves(sub(whole))):
            for i, e in enumerate(ps):
                n = M.axis_size(mesh, entry_axes(e)) if e is not None else 1
                if x.shape[i] * n != g.shape[i] or (n > 1 and x.shape[i] == g.shape[i]):
                    wrong.append(f"{keys}{path} dim {i}")
            seq.append(M.axis_size(mesh, entry_axes(ps[x.dim() - 3])) if ps[x.dim() - 3] else 1)
    out[f"{name}/cache_wrong"] = np.array(wrong or [""])
    out[f"{name}/cache_seq_split"] = np.array(seq)
    return whole

def fed_logits(model, params, batch, feed, mesh, pad_to=S + STEPS, keep=None):
    """(B, STEPS, V) float32: the prefill's last-position logits and three
    decode steps', each step fed ``feed``'s token; with ``keep`` (a case's
    name) every step's whole cache is kept under it."""
    cfg = model.cfg
    cache, lg = model.prefill(params, batch, mesh=mesh)
    layout = None if mesh is None else decode_layout_of(model, batch, mesh, pad_to)
    cache = _pad_seq(cfg, cache, S, feed.shape[0], pad_to, mesh=mesh, layout=layout)
    lgs = [gather_last(cfg, mesh, lg[:, -1])]
    for i in range(STEPS - 1):
        db = decode_batch(cfg, feed[:, i:i + 1].contiguous(), S + i)
        lg, cache = model.decode_step(params, cache, db, S + i, mesh=mesh, layout=layout)
        lgs.append(gather_last(cfg, mesh, lg[:, -1]))
        if keep:
            whole = cache if mesh is None else cache_blocks(keep, cfg, mesh, layout, cache)
            for j, (_, x) in enumerate(T.leaves(whole)):
                out[f"{keep}/cache{i}/{j}"] = (x.view(torch.int16).numpy().view(np.uint16)
                                               if x.dtype == torch.bfloat16 else x.numpy())
    return np.stack(lgs, 1)

def float32(model):
    return dataclasses.replace(model, policy=dataclasses.replace(model.policy,
                                                                 compute=torch.float32))

for name, case in SERVE.items():
    arch, shape, over, b, pad_to, split = case_of(case)
    if math.prod(shape) != world:
        continue
    mesh = mesh_of(shape)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = build(cfg, tp=shape[1])
    whole = params_from_numpy(model.specs, init_numpy(model.specs, seed=0), "cpu")
    run = run_pspecs(model, mesh)
    params = T.tree_map(lambda x, ps: shard(x, named(mesh, ps)), whole, run)
    layout(name, mesh, params, run, whole)
    gbatch, batch = {}, {}
    for k in ("tokens", "vision_embeds", "mrope_pos", "enc_feats"):
        if f"{name}/batch/{k}" in j:
            v = torch.from_numpy(j[f"{name}/batch/{k}"])
            gbatch[k] = v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            batch[k] = shard(gbatch[k], named(mesh, P(None, "data") if k == "mrope_pos"
                                              else P("data")))
    toks = greedy_generate(model, params, batch, steps=STEPS, mesh=mesh, pad_to=pad_to)
    out[f"{name}/tokens"] = unshard(toks, named(mesh, P("data"))).numpy()
    gfeed = torch.from_numpy(j[f"{name}/tokens"])
    feed = shard(gfeed, named(mesh, P("data")))
    out[f"{name}/logits"] = fed_logits(model, params, batch, feed, mesh, pad_to,
                                       keep=name if split else None)
    if split:  # the port's one-device cache, beside the JAX package's
        fed_logits(model, whole, gbatch, gfeed, None, pad_to, keep=f"{name}/plain")
    out[f"{name}/f32_logits"] = fed_logits(float32(model), params, batch, feed, mesh, pad_to,
                                           keep=f"{name}/f32" if split else None)
    out[f"{name}/f32_plain_logits"] = fed_logits(float32(model), whole, gbatch, gfeed, None,
                                                 pad_to,
                                                 keep=f"{name}/f32_plain" if split else None)
    if name in LOSS:
        out[f"{name}/loss"] = np.array(float(model.loss(params, batch, mesh=mesh)[0]))

def exact_grads(name, model, mesh, oc, dc, whole):
    """In float32 compute: the loss and each leaf's gradient on the mesh
    (this rank's, reduced to its gradient block as the step reduces it,
    gathered) and on one device; the largest gap of each leaf over its
    largest entry."""
    f32 = float32(model)
    gb = {k: torch.as_tensor(v) for k, v in data.batch_at(dc, 0).items()}
    plain_loss, _, plain = ts._value_and_grad(f32, whole, gb)
    run = dict(T.leaves(run_pspecs(f32, mesh)))
    gl = dict(T.leaves(ts._layouts(f32, oc, mesh)["grads"]))
    local = T.map_with_path(lambda p, x: shard(x, named(mesh, run[p])), whole)
    loss, _, grads = ts._value_and_grad(f32, local, data.device_batch_at(dc, 0, mesh=mesh,
                                                                        device="cpu"), mesh)
    n = M.chips(mesh)
    loss = M.all_reduce(loss, mesh, tuple(mesh.mesh_dim_names)) / n
    gaps = []
    for (p, g), (_, ref) in zip(T.leaves(grads), T.leaves(plain)):
        got = unshard(ts._reduce_grad(g, mesh, run[p], gl[p], n), named(mesh, gl[p]))
        gaps.append(float((got - ref.float()).abs().max() / (ref.float().abs().max() + 1e-30)))
    out[f"train_{name}/f32_loss"] = np.array([float(loss), float(plain_loss)])
    out[f"train_{name}/f32_grad_gaps"] = np.array(gaps)

for name, (arch, shape, over) in TRAIN.items():
    shape = tuple(shape)
    if math.prod(shape) != world:
        continue
    mesh = mesh_of(shape)
    model = build(dataclasses.replace(get_smoke_config(arch), **over), tp=shape[1])
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    state = {"params": params_from_numpy(model.specs, init_numpy(model.specs, seed=0), "cpu"),
             "opt": init_params(ts.state_specs(model, oc)["opt"], torch.Generator(), "cpu")}
    sh = ts.state_shardings(model, oc, mesh)
    whole = T.tree_map(lambda x: x.clone(), state)
    state = T.tree_map(shard, state, sh)
    layout(f"train_{name}", mesh, state, T.tree_map(lambda s: s.spec, sh), whole)
    step = ts.make_train_step(model, oc, mesh=mesh)
    dc = data.DataConfig(model.cfg.vocab_size, S, 8, seed=0)
    exact_grads(name, model, mesh, oc, dc, whole["params"])
    for i in range(2):
        state, m = step(state, data.device_batch_at(dc, i, mesh=mesh, device="cpu"))
        for k, v in m.items():
            out[f"train_{name}:m{i}/{k}"] = v.numpy()
        for path, x in T.leaves(T.tree_map(unshard, state, sh)):
            out[f"train_{name}@{i}{path}"] = x.numpy().copy()
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
dist.destroy_process_group()
'''


def run(tmp_path_factory, serve, train=None, loss=(), measure=False, checks=()):
    """{"jax": arrays, world size: {rank: arrays}} for the cases; ``checks``
    names the JAX side's extra checks ("f10": placing ROADMAP F10's cache
    pspec, its message)."""
    train = dict(train or {})
    values = dict(b=B, s=S, steps=STEPS, nv=N_VISION, frames=FRAMES, serve=dict(serve),
                  train=train, loss=list(loss), measure=measure, checks=list(checks))
    jdir = tmp_path_factory.mktemp("tp_jax")
    run_with_devices((JAX_SIDE % values).replace("sys.argv[1]", repr(str(jdir))), n_devices=8,
                     timeout=900)
    got = {"jax": dict(np.load(jdir / "jax.npz"))}
    code = "import math\n" + TORCH_SIDE % values
    for world in sorted({math.prod(case[1]) for case in [*serve.values(), *train.values()]}):
        wdir = tmp_path_factory.mktemp(f"tp_world{world}")
        (wdir / "jax.npz").symlink_to(jdir / "jax.npz")
        run_torch_world(code, world, wdir, timeout=600)
        got[world] = {r: dict(np.load(wdir / f"rank{r}.npz")) for r in range(world)}
    return got


def logit_gap(a, b):
    """The largest absolute difference of two logit arrays (float32)."""
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def tokens_where_margin(got, want, margins, tol):
    """Tokens equal wherever the JAX margin exceeds ``tol``; a row is not
    compared past a position where a token it does not hold differs.
    Returns the count compared."""
    compared = 0
    for r in range(want.shape[0]):
        for i in range(want.shape[1]):
            if margins[r, i] > tol:
                assert got[r, i] == want[r, i], (r, i, got[r], want[r], margins[r])
                compared += 1
            elif got[r, i] != want[r, i]:
                break
    return compared
