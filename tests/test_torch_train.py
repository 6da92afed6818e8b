"""The port's training substrate (``repro_torch.train``,
``repro_torch.launch.train``) against the JAX package's ``repro.train``:
the synthetic data bit for bit, the schedule, the optimizer's spec tree,
AdamW with float32 and int8 moments, compression, checkpoints written by
either package restored by the other, train steps of qwen3-1.7b-smoke,
accumulation, the decoupled pod round, and the launcher's crash and
resume.  Each input is made with numpy and fed to both packages (each
with its own copy: on the CPU ``params_from_numpy`` and ``jnp.asarray``
share the arrays, which the port's in-place update would change).

Tolerances.  The data, the spec trees, compression and checkpoints are
equal bit for bit.  The schedule agrees to an ulp or two of float32 where
the value is not small, and to 9.0e-11 absolute near the end of the decay,
where ``1 + cos(pi * t)`` cancels an ulp of difference in ``cos``: held at
rtol 1e-6 / atol 1e-10.  AdamW on equal params, grads and state differs
only in the rounding of ``b ** step``, the order of the global norm's sum
and XLA's fusion of the update: after three steps the params agree to an
ulp or two of their larger entries (at most 4.8e-7 absolute at |p| up to
~4), m to 1.0e-9 and v to 3.6e-11 absolute, the int8 moments' ``q``
exactly and their scales to 5.2e-7 relative; held at rtol 1e-6 / atol
1e-7 (``q`` equal).  A train step of the smoke model
from equal weights: loss and ce 3.8e-7 relative (bf16 forward, float32
reductions in another order), grad_norm 7.2e-5 (the bf16 backward's
rounding); held at 2e-6 and 2e-4.  After it the params differ by 1.0e-6 on
average, but an entry whose gradient is near zero may take its first Adam
step (size ~lr) the other way: 0.24% of entries differ by more than 1e-5,
at most 1.2e-3 = 2 lr.  Held at: at most 2 lr, under 1% past 1e-5, mean
under 1e-5.  The second step's loss then differs by 6.6e-6 (2.7e-5 with
accumulation over the smaller batch; held at 5e-5), its grad_norm by
2.7e-4 (held at 4e-4).  The decoupled round is compared at a
quantum of one step, so its outer params and momentum are held as a step's
params.  Measured with one torch thread,
torch 2.13 and jax 0.9 on a CPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.common import ParamSpec as JParamSpec
from repro.common import init_params as jinit_params
from repro.models.model import build as jax_build
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train.decoupled import DecoupledConfig as JDecoupledConfig
from repro.train.decoupled import make_decoupled_round as jax_round
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.common import ParamSpec, init_numpy, init_params
from repro_torch.models.model import build, params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import data, optimizer, train_step
from repro_torch.train.decoupled import DecoupledConfig, make_decoupled_round, outer_state_specs
from torch_parity import jax_params, single_torch_thread

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAM = dict(rtol=1e-6, atol=1e-7)
ARCH = "qwen3-1.7b"


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _leaves_np(tree_t):
    return [_np(x) for _, x in T.leaves(tree_t)]


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 4, 1), (151936, 128, 8, 7),
                                                  (51865, 33, 3, 0), (40, 16, 2, 5)])
def test_batch_at_matches_jax(vocab, seq, batch, seed):
    for step in (0, 1, 17, 1000):
        got = data.batch_at(data.DataConfig(vocab, seq, batch, seed), step)["tokens"]
        want = np.asarray(jdata.batch_at(jdata.DataConfig(vocab, seq, batch, seed), step)["tokens"])
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_data_deterministic_and_step_dependent():
    dc = data.DataConfig(vocab_size=512, seq_len=64, global_batch=4, seed=1)
    a, b, c = (data.batch_at(dc, s)["tokens"].numpy() for s in (3, 3, 4))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 512


def test_data_has_learnable_structure():
    dc = data.DataConfig(vocab_size=512, seq_len=128, global_batch=8, seed=0)
    t = data.batch_at(dc, 0)["tokens"].numpy()
    assert (t[:, dc.structure:] == (t[:, :-dc.structure] + 1) % 64).mean() > 0.5


def test_device_batch_at_places_and_refuses_a_mesh():
    dc = data.DataConfig(512, 16, 2)
    extras = lambda cfg, step: {"enc_feats": torch.zeros((2, 16, 8), dtype=torch.bfloat16)}
    got = data.device_batch_at(dc, 3, extras=extras, device="cpu")
    assert set(got) == {"tokens", "enc_feats"} and got["tokens"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="item 12"):
        data.device_batch_at(dc, 3, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# optimizer


def test_schedule_matches_jax():
    oc = optimizer.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    joc = jopt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    steps = np.arange(0, 230, dtype=np.int32)
    got = optimizer.schedule(oc, torch.from_numpy(steps))
    want = np.asarray(jopt.schedule(joc, jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-10)
    assert float(got[0]) == 0.0 and abs(float(got[20]) - 3e-3) < 1e-9


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "kimi-k2-1t-a32b"])
def test_opt_specs_match_jax(arch):
    cfg = configs.get_smoke_config(arch)
    specs = build(cfg).specs
    jspecs = jax_build(jconfigs.get_smoke_config(arch), tp=1).specs
    got = T.leaves(optimizer.opt_specs(specs, optimizer.OptConfig(moments_dtype=cfg.moments_dtype)))
    want = T.leaves(jax.tree.map(
        lambda s: f"{tuple(s.shape)} {jnp.dtype(s.dtype)}",
        jopt.opt_specs(jspecs, jopt.OptConfig(moments_dtype=jconfigs.get_smoke_config(arch)
                                              .moments_dtype)),
        is_leaf=lambda x: isinstance(x, JParamSpec)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, s), (_, w) in zip(got, want):
        assert f"{tuple(s.shape)} {str(s.dtype).replace('torch.', '')}" == w, p
        assert s.init == "zeros", p


def _adam_inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    params = {f"w{i}": rng.normal(0, 1, s).astype(np.float32) for i, s in enumerate(shapes)}
    grads = [{k: (rng.normal(0, 0.3, v.shape) * (1 + 5 * (i == 1))).astype(np.float32)
              for k, v in params.items()} for i in range(3)]
    return params, grads


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_update_matches_jax(moments):
    """Three AdamW steps (the second one clipped) from zero moments on equal
    params and grads: params, moments, step, grad_norm and lr."""
    shapes = [(64, 128), (3, 40, 17), (256,)]
    params, grads = _adam_inputs(0, shapes)
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}[moments]
    oc = optimizer.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, moments_dtype=tdt)
    joc = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, moments_dtype=jdt)
    specs = {k: ParamSpec(v.shape) for k, v in params.items()}
    jspecs = {k: JParamSpec(v.shape, jnp.float32, jax.sharding.PartitionSpec())
              for k, v in params.items()}
    opt = init_params(optimizer.opt_specs(specs, oc), torch.Generator(), "cpu")
    jopt_state = jinit_params(jax.random.PRNGKey(0), jopt.opt_specs(jspecs, joc))
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    update = jax.jit(lambda p, g, o: jopt.adamw_update(joc, p, g, o))
    for g in grads:
        _, _, m = optimizer.adamw_update(oc, p, {k: torch.from_numpy(v) for k, v in g.items()},
                                         opt)
        jp, jopt_state, jm = update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jopt_state)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **ADAM, err_msg=k)
    assert int(opt["step"]) == int(jopt_state["step"]) == 3
    for (path, got), want in zip(T.leaves(opt), jax.tree.leaves(jopt_state)):
        want = np.asarray(want)
        assert got.dtype == getattr(torch, str(want.dtype)), path
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        else:
            np.testing.assert_allclose(got.numpy(), want, **ADAM, err_msg=path)


@pytest.mark.parametrize("moments", [torch.float32, torch.int8])
def test_adamw_slabs_change_no_value(moments, monkeypatch):
    """A leaf updated in slabs along its leading axis (as the large ones are)
    gives the whole leaf's update bit for bit, int8 moments' scales too."""
    out = []
    for slab in (1 << 27, 1000):
        monkeypatch.setattr(optimizer, "_SLAB", slab)
        oc = optimizer.OptConfig(lr=1e-2, moments_dtype=moments)
        g = torch.Generator().manual_seed(0)
        shapes = {"a": (7, 30, 20), "b": (50,)}
        p = {k: torch.randn(v, generator=g) for k, v in shapes.items()}
        opt = init_params(optimizer.opt_specs({k: ParamSpec(v) for k, v in shapes.items()}, oc),
                          torch.Generator(), "cpu")
        for _ in range(3):
            optimizer.adamw_update(oc, p, {k: torch.randn(v, generator=g)
                                           for k, v in shapes.items()}, opt)
        out.append({"p": p, "opt": opt})
    assert len(optimizer._slabs(out[1]["p"]["a"])) == 7
    for (path, a), (_, b) in zip(T.leaves(out[0]), T.leaves(out[1])):
        assert torch.equal(a, b), path


def test_int8_moments_update_close_to_fp32():
    rng = np.random.default_rng(0)
    p0 = rng.normal(0, 1, (64, 128)).astype(np.float32)
    g = {"w": torch.from_numpy((rng.normal(0, 1, (64, 128)) * 0.1).astype(np.float32))}
    out = {}
    for dtype in (torch.float32, torch.int8):
        oc = optimizer.OptConfig(lr=1e-2, moments_dtype=dtype)
        opt = init_params(optimizer.opt_specs({"w": ParamSpec((64, 128))}, oc),
                          torch.Generator(), "cpu")
        p = {"w": torch.from_numpy(p0.copy())}
        optimizer.adamw_update(oc, p, g, opt)
        out[dtype] = p["w"].numpy()
    np.testing.assert_allclose(out[torch.int8], out[torch.float32], atol=2e-3)


def test_int8_moments_drop_small_entries_of_v_as_jax():
    """ROADMAP F5, pinned: int8 moments quantize each row to steps of
    (row max)/127, so v (which holds g^2) rounds an entry below ~6.3% of its
    row's largest to 0 at every step, while m keeps its history.  One row
    g = [1.0, 0.03, 0.003], params and moments zero, no warmup, no decay,
    no clip, three steps: params and moments equal the JAX package's, v
    dequantizes to [0.1426, 0, 0], and the params part from float32's."""
    g = np.array([[1.0, 0.03, 0.003]], np.float32)
    kw = dict(warmup_steps=0, weight_decay=0.0, grad_clip=1e9)
    oc = optimizer.OptConfig(moments_dtype=torch.int8, **kw)
    joc = jopt.OptConfig(moments_dtype=jnp.int8, **kw)
    opt = init_params(optimizer.opt_specs({"w": ParamSpec((1, 3), init="zeros")}, oc),
                      torch.Generator(), "cpu")
    jspecs = {"w": JParamSpec((1, 3), jnp.float32, jax.sharding.PartitionSpec(), "zeros")}
    jopt_state = jinit_params(jax.random.PRNGKey(0), jopt.opt_specs(jspecs, joc))
    p, jp = {"w": torch.zeros((1, 3))}, {"w": jnp.zeros((1, 3), jnp.float32)}
    for _ in range(3):
        optimizer.adamw_update(oc, p, {"w": torch.from_numpy(g)}, opt)
        jp, jopt_state, _ = jopt.adamw_update(joc, jp, {"w": jnp.asarray(g)}, jopt_state)
    np.testing.assert_array_equal(p["w"].numpy(), np.asarray(jp["w"]))
    for (path, got), want in zip(T.leaves(opt), jax.tree.leaves(jopt_state)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
    v = {path: x for path, x in T.leaves(opt) if path.startswith("/v/w")}
    v = (v["/v/w/q"].float() * v["/v/w/scale"].unsqueeze(-1)).numpy()
    np.testing.assert_allclose(v, [[0.1426, 0.0, 0.0]], atol=5e-5)
    np.testing.assert_allclose(p["w"].numpy(), [[-0.0009, -0.00125145, -0.00070745]],
                               rtol=2e-5)


def test_requant_rounds_half_to_even():
    like = {"q": torch.zeros((1, 4), dtype=torch.int8), "scale": torch.zeros((1,))}
    val = torch.tensor([[127.0, 0.5, 1.5, -2.5]])
    got = optimizer._requant(val, like)
    want = jopt._requant(jnp.asarray(val.numpy()), {"q": 0, "scale": 0})
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert got["q"].tolist() == [[127, 0, 2, -2]]


def test_mesh_paths_refuse():
    model = build(configs.get_smoke_config(ARCH))
    oc = optimizer.OptConfig()
    for call in (lambda: train_step.make_train_step(model, oc, mesh=object()),
                 lambda: train_step.grad_pspecs(model),
                 lambda: optimizer.zero1_pspec(ParamSpec((16, 16)))):
        with pytest.raises(NotImplementedError, match="item 12"):
            call()


# ---------------------------------------------------------------------------
# compression


@pytest.mark.parametrize("shape", [(17,), (256,), (64, 129), (3, 5, 7)])
def test_compress_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 1, shape).astype(np.float32)
    # the first block's largest magnitude 63.5 makes its scale 0.5 (1e-12 is
    # below its ulp): these values land on halves, rounded to even
    x.reshape(-1)[:8] = [63.5, 0.25, 0.75, 1.25, -1.25, -0.25, 2.25, 0.0]
    q, s, shp = comp.compress(torch.from_numpy(x))
    assert q.reshape(-1)[:8].tolist() == [127, 0, 2, 2, -2, 0, 4, 0]
    jq, js, jshp = jcomp.compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and shp == tuple(jshp) == shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(comp.decompress(q, s, shp).numpy(),
                                  np.asarray(jcomp.decompress(jq, js, jshp)))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from([(17,), (256,), (64, 129)]))
def test_compression_roundtrip_error_bound(seed, shape):
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32))
    back = comp.decompress(*comp.compress(x))
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_compression_error_feedback_accumulates():
    x = {"w": torch.full((256,), 0.003)}
    ef, total = None, torch.zeros((256,))
    for _ in range(50):
        c, ef = comp.compress_tree(x, ef)
        total = total + comp.decompress(*c["w"])
    np.testing.assert_allclose(float(total.mean()) / 50, 0.003, rtol=0.05)


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(0, 1, (300,)).astype(np.float32),
            "b": {"c": rng.normal(0, 2, (7, 9)).astype(np.float32)}}
    tt = T.tree_map(torch.from_numpy, tree)
    jt = jax.tree.map(jnp.asarray, tree)
    c, ef = comp.compress_tree(tt)
    c, ef = comp.compress_tree(tt, ef)
    jc, jef = jcomp.compress_tree(jt)
    jc, jef = jcomp.compress_tree(jt, jef)
    for (p, got), want in zip(T.leaves(ef), jax.tree.leaves(jef)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=p)
    back = comp.decompress_tree(c)
    jback = jcomp.decompress_tree(jc)
    for (p, got), want in zip(T.leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=p)
    assert comp.compressed_bytes(tt) == jcomp.compressed_bytes(jt)


# ---------------------------------------------------------------------------
# checkpoints


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(0, 1, (10, 3)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.integers(-100, 100, (5,)).astype(np.int8)),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "e": torch.from_numpy(rng.normal(0, 1, (4,)).astype(np.float32))}


def _assert_same(got, want):
    assert [p for p, _ in T.leaves(got)] == [p for p, _ in T.leaves(want)]
    for (p, g), (_, w) in zip(T.leaves(got), T.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, p
        assert torch.equal(g, w), p


def test_checkpoint_roundtrip_and_corruption(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    ckpt.save(tmp_path, 1, t1)
    ckpt.save(tmp_path, 2, t2)
    assert ckpt.latest_step(tmp_path) == 2
    got, at = ckpt.restore(tmp_path, t1)
    assert at == 2
    _assert_same(got, t2)
    ckpt.corrupt_for_test(tmp_path, 2)
    assert ckpt.latest_step(tmp_path) == 1
    got, at = ckpt.restore(tmp_path, t1)
    assert at == 1
    _assert_same(got, t1)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(tmp_path, t1, step=2)


def test_async_checkpoint(tmp_path):
    tree = {"a": torch.arange(100.0), "b": {"c": torch.ones((3, 4))}}
    t = ckpt.save(tmp_path, 7, tree, async_write=True)
    t.join(timeout=60)
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 7
    _assert_same(restored, tree)


def test_checkpoints_cross_between_packages(tmp_path):
    tree = _tree(3)
    jtree = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)
    jckpt.save(tmp_path / "jax", 5, jtree)
    got, at = ckpt.restore(tmp_path / "jax", tree)
    assert at == 5
    _assert_same(got, tree)
    ckpt.save(tmp_path / "port", 6, tree)
    jgot, at = jckpt.restore(tmp_path / "port", jtree)
    assert at == 6
    for (p, w), g in zip(T.leaves(tree), jax.tree.leaves(jgot)):
        g = np.asarray(g)
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy()), p
    assert (json_manifest(tmp_path / "port" / "step_00000006")["dtypes"]
            == json_manifest(tmp_path / "jax" / "step_00000005")["dtypes"])


def json_manifest(path):
    import json

    return json.loads((path / "manifest.json").read_text())


def test_checkpoint_bf16_leaf_roundtrip(tmp_path):
    x = torch.randn((6, 5), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tree = {"w": x, "f": torch.ones(3)}
    ckpt.save(tmp_path, 1, tree)
    assert json_manifest(tmp_path / "step_00000001")["dtypes"] == ["float32", "bfloat16"]
    got, _ = ckpt.restore(tmp_path, {"w": ParamSpec((6, 5), torch.bfloat16),
                                     "f": ParamSpec((3,))}, device="cpu")
    _assert_same(got, tree)


# ---------------------------------------------------------------------------
# the train step


def _setup(accum=1, lr=3e-3):
    cfg = configs.get_smoke_config(ARCH)
    model = build(cfg)
    oc = optimizer.OptConfig(lr=lr, warmup_steps=5, total_steps=100)
    weights = init_numpy(model.specs, seed=0)
    state = {"params": _own_params(model, weights),
             "opt": init_params(train_step.state_specs(model, oc)["opt"], torch.Generator(),
                                "cpu")}
    return cfg, model, oc, weights, state, train_step.make_train_step(model, oc, accum)


def _own_params(model, weights):
    """The port's parameters in memory of their own: on the CPU
    ``params_from_numpy`` (and ``jnp.asarray``) share the numpy arrays, which
    the in-place update would otherwise change under the JAX package."""
    return params_from_numpy(model.specs, T.tree_map(np.copy, weights), "cpu")


def _jax_setup(weights, accum=1, lr=3e-3):
    jm = jax_build(jconfigs.get_smoke_config(ARCH), tp=1)
    joc = jopt.OptConfig(lr=lr, warmup_steps=5, total_steps=100)
    jstate = {"params": jax_params(weights),
              "opt": jinit_params(jax.random.PRNGKey(1), jts.state_specs(jm, joc)["opt"])}
    return jm, jstate, jax.jit(jts.make_train_step(jm, joc, accum_steps=accum))


def _close_after_step(got, jwant, lr):
    """Params after AdamW steps of total size ``lr`` (see the module doc)."""
    diffs = np.concatenate([np.abs(_np(g) - np.asarray(w, np.float32)).ravel()
                            for (_, g), w in zip(T.leaves(got), jax.tree.leaves(jwant))])
    assert diffs.max() <= 2 * lr * 1.001 + 1e-6, diffs.max()
    assert (diffs > 1e-5).mean() < 0.01, (diffs > 1e-5).mean()
    assert diffs.mean() < 1e-5, diffs.mean()


def _steps_match_jax(accum, seq, batch_size):
    cfg, model, oc, weights, state, step = _setup(accum=accum)
    jm, jstate, jstep = _jax_setup(weights, accum=accum)
    dc = data.DataConfig(cfg.vocab_size, seq, batch_size, seed=3)
    for i, loss_tol in enumerate((2e-6, 5e-5)):
        batch = data.batch_at(dc, i)
        state, m = step(state, batch)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"].numpy())})
        assert set(m) == set(jmet) and all(v.shape == () for v in m.values())
        for k, tol in (("loss", loss_tol), ("ce", loss_tol), ("grad_norm", 2e-4 * (i + 1)),
                       ("lr", 1e-6)):
            np.testing.assert_allclose(float(m[k]), float(jmet[k]), rtol=tol, err_msg=k)
        if i == 0:
            _close_after_step(state["params"], jstate["params"], float(m["lr"]))
    assert int(state["opt"]["step"]) == 2


def test_train_step_matches_jax():
    _steps_match_jax(accum=1, seq=64, batch_size=8)


def test_grad_accumulation_matches_single_batch():
    cfg, model, oc, weights, s1, step1 = _setup(accum=1)
    *_, s4, step4 = _setup(accum=4)
    b = data.batch_at(data.DataConfig(cfg.vocab_size, 64, 8, seed=3), 0)
    s1, m1 = step1(s1, b)
    s4, m4 = step4(s4, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    d = max(float((a - c).abs().max()) for (_, a), (_, c) in
            zip(T.leaves(s1["params"]), T.leaves(s4["params"])))
    assert d < 5e-3, d


def test_accumulated_step_matches_jax():
    _steps_match_jax(accum=2, seq=32, batch_size=4)


def test_loss_decreases():
    cfg, model, oc, weights, state, step = _setup()
    dc = data.DataConfig(cfg.vocab_size, 64, 8, seed=3)
    losses = []
    for i in range(40):
        state, m = step(state, data.batch_at(dc, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]


# ---------------------------------------------------------------------------
# decoupled pods


def _pods(cfg, model, oc, weights, n_pods):
    opt = init_params(train_step.state_specs(model, oc)["opt"], torch.Generator(), "cpu")
    params = _own_params(model, weights)
    inner = T.tree_map(lambda x: torch.stack([x] * n_pods), {"params": params, "opt": opt})
    outer = {"params": _own_params(model, weights),
             "momentum": init_params(outer_state_specs(model), torch.Generator(), "cpu")}
    return inner, outer


def _pod_batches(dc, r, n_pods, quantum):
    toks = [data.batch_at(dc, r * n_pods * quantum + i)["tokens"] for i in range(n_pods * quantum)]
    return {"tokens": torch.stack(toks).reshape(n_pods, quantum, *toks[0].shape)}


def test_decoupled_round_matches_jax():
    cfg, model, oc, weights, _, step = _setup()
    n_pods, quantum = 2, 1
    inner, outer = _pods(cfg, model, oc, weights, n_pods)
    rnd = make_decoupled_round(model, oc, DecoupledConfig(quantum=quantum), step, n_pods)
    jm = jax_build(jconfigs.get_smoke_config(ARCH), tp=1)
    joc = jopt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    jinner_step = jts.make_train_step(jm, joc)
    jrnd = jax.jit(jax_round(jm, joc, JDecoupledConfig(quantum=quantum), jinner_step, n_pods))
    jp = jax_params(weights)
    jopt0 = jinit_params(jax.random.PRNGKey(1), jts.state_specs(jm, joc)["opt"])
    jinner = jax.tree.map(lambda x: jnp.stack([x] * n_pods), {"params": jp, "opt": jopt0})
    jouter = {"params": jp, "momentum": jax.tree.map(jnp.zeros_like, jp)}
    dc = data.DataConfig(cfg.vocab_size, 32, 4, seed=5)
    batches = _pod_batches(dc, 0, n_pods, quantum)
    inner, outer, m = rnd(inner, outer, batches)
    jinner, jouter, jmet = jrnd(jinner, jouter, {"tokens": jnp.asarray(batches["tokens"].numpy())})
    np.testing.assert_allclose(m["pod_losses"].numpy(), np.asarray(jmet["pod_losses"]), rtol=2e-6)
    lr = float(optimizer.schedule(oc, 1))
    _close_after_step(outer["params"], jouter["params"], lr)
    _close_after_step(outer["momentum"], jouter["momentum"], lr)
    for (p, got), (_, o) in zip(T.leaves(inner["params"]), T.leaves(outer["params"])):
        assert all(torch.equal(got[i], o) for i in range(n_pods)), p


def test_decoupled_pod_training_learns():
    cfg, model, oc, weights, _, step = _setup()
    n_pods, quantum = 2, 4
    oc = optimizer.OptConfig(lr=3e-3, warmup_steps=5, total_steps=200)
    step = train_step.make_train_step(model, oc)
    inner, outer = _pods(cfg, model, oc, weights, n_pods)
    rnd = make_decoupled_round(model, oc, DecoupledConfig(quantum=quantum), step, n_pods)
    dc = data.DataConfig(cfg.vocab_size, 64, 4, seed=5)
    losses = []
    for r in range(8):
        inner, outer, m = rnd(inner, outer, _pod_batches(dc, r, n_pods, quantum))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.85, losses


# ---------------------------------------------------------------------------
# the launcher


def _launch(args, **env):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=dict(os.environ, PYTHONPATH="src", **env), capture_output=True,
                          text=True, cwd=REPO, timeout=600)


def test_train_driver_failure_resume(tmp_path):
    """Crash at step 30 (exit 17), run again: resumes from step 30, finishes."""
    args = ["--device", "cpu", "--steps", "40", "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "10", "--log-every", "100"]
    r1 = _launch(args + ["--fail-at-step", "30"], OMP_NUM_THREADS="1")
    assert r1.returncode == 17, r1.stderr[-1500:]
    r2 = _launch(args, OMP_NUM_THREADS="1")
    assert r2.returncode == 0, r2.stderr[-1500:]
    assert "resumed from checkpoint step 30" in r2.stdout
    assert "training complete" in r2.stdout


def test_train_launcher_needs_a_card_unless_told():
    from repro_torch.launch import train as launch_train

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the launcher would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
