"""Split-KV decode (ROADMAP item 16) against the JAX package's GSPMD runs:
every attention cache held as ``cache_specs`` splits it at the cache's
global batch and length, each rank on its block of positions, the decode
softmax combined over the ranks.  The JAX side jits ``decode_step`` as
``launch/dryrun.py`` does, the cache placed and returned in ``cache_specs``'
shardings over 4 of 8 fake devices, greedy on its own tokens; the port's
side runs a gloo world of 4 at (data, model) = (2, 2), fed the JAX
package's tokens (``tests/tp_parity.py`` runs both sides).  The cases,
each one smoke config at tp = 2:

- ``seq_data``: qwen3-1.7b, B = 4, a 16-token prompt padded to 40: its 2
  kv heads over 'model', the sequence over 'data', so data rank 1's block
  (positions 20-39) is wholly masked at every step;
- ``seq_data_model``: granite-34b (1 kv head), B = 4, padded to 40: the
  sequence over ('data', 'model'), blocks of 10, two of them wholly
  masked;
- ``seq_model_clamped``: granite-34b, B = 16, no ``pad_to``: the batch over
  'data', the sequence over 'model', and each step's write clamped to
  position 15 (ROADMAP F2), on model rank 1;
- ``hybrid``: zamba2-2.7b, B = 4: the shared attention's cache over 'data';
- ``encdec``: whisper-tiny, B = 4: the self cache and the 64-frame cross
  memory over 'data'.

Bounds (``LOGITS``): twice the JAX package's own largest logit distance
between this run and its run without a mesh (fed the same tokens),
measured on these inputs with jax 0.9 on a CPU: seq_data 0.0039,
seq_data_model 0.42, seq_model_clamped 0.43 (its prefill), hybrid 0.11,
encdec 0.13.  The port against the JAX package's mesh run, the same
measurement with torch 2.13: 2.4e-7, 0, 3.1e-5, 0, 0.18.  Greedy tokens
are compared where the JAX package's margin exceeds its own distance
(``OWN``): 15, 5, 3, 11 and 1 of the 16 positions.  The gathered caches
(``CACHE``, over the steps, the attention entries): twice the larger of
the two packages' own distances between their mesh and one-device runs,
0.125, 1.63, 3.06 (position 15 left out, F11), 0.125 and 1.23; the
port's distance from the JAX package's mesh cache is 0 in the first four
and 1.23 for whisper-tiny, whose memory the port's tensor-parallel
encoder (ROADMAP item 14's layout, computed before any split read) puts
0.63 from both of the JAX package's runs and from its own one-device run
(F3's near-one-hot softmax rows).

``seq_model_clamped`` shows ROADMAP F11: the JAX package's sharded decode
drops the clamped write (its position 15 keeps the prompt's entry at every
step) where its unsharded decode overwrites it, as its
``dynamic_update_slice`` says.  The port keeps the write (F2), so its
decode logits are not held to the sharded run, only its prefill's;
test_f2_clamped_write_lands_on_the_rank_that_holds_it_f11 pins both sides
of F11.

The bf16 bounds carry rounding, so every case also runs in float32
compute on the mesh and on one device: the fed logits within ``F32`` of
the largest logit (measured 3.6e-7, 9.1e-6, 1.1e-5, 1.6e-6 and 2.7e-5),
the gathered attention caches within 1e-5 of their largest entry
(measured 2.8e-7 to 4.6e-6).  ``F32`` is 1e-5 as tests/test_torch_tp.py
holds its cases, whisper-tiny's 5e-5 as there; granite-34b's 2e-5: its
tensor-parallel prefill alone, before any split read, is 9.1e-6 of its
largest logit from the one-device run (1 kv head and F3's near-one-hot
softmax rows magnify the reassociated sums).

ROADMAP F10 is pinned here too: the reference tests a sequence it splits
over 'data' against the 'model' size, so on a (data, model) = (4, 2) mesh
it chooses a pspec that ``jax.device_put`` refuses, and the port refuses
it with the same substance.  ``test_block_combine_*`` holds the partial
softmax and its combine (``layers.block_scores``/``block_weights``/
``block_output``, run here block by block in one process) against the
whole-sequence attention.
"""
import functools
import types

import numpy as np
import pytest
import torch

from tp_parity import STEPS, logit_gap, run, tokens_where_margin

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import _grouped_decode_attention

CASES = {
    "seq_data": ("qwen3-1.7b", (2, 2), {}, {"pad_to": 40, "split_kv": True}),
    "seq_data_model": ("granite-34b", (2, 2), {}, {"pad_to": 40, "split_kv": True}),
    "seq_model_clamped": ("granite-34b", (2, 2), {}, {"batch": 16, "pad_to": None,
                                                      "split_kv": True}),
    "hybrid": ("zamba2-2.7b", (2, 2), {}, {"split_kv": True}),
    "encdec": ("whisper-tiny", (2, 2), {}, {"split_kv": True}),
}
# the blocks the sequence dim of each attention leaf is split into
SEQ_SPLIT = {"seq_data": 2, "seq_data_model": 4, "seq_model_clamped": 2, "hybrid": 2,
             "encdec": 2}
# the JAX package's own mesh-vs-no-mesh logit distances (the module's docstring)
OWN = {"seq_data": 0.00390625, "seq_data_model": 0.421875, "seq_model_clamped": 0.4287109375,
       "hybrid": 0.109375, "encdec": 0.1279296875}
LOGITS = {k: 2 * v for k, v in OWN.items()}
# twice the larger of the two packages' own mesh-vs-one-device cache distances
CACHE = {"seq_data": 0.25, "seq_data_model": 3.25, "seq_model_clamped": 6.125,
         "hybrid": 0.25, "encdec": 2.46875}
F32 = {k: 2e-5 if CASES[k][0] == "granite-34b" else 5e-5 if k == "encdec" else 1e-5
       for k in CASES}
CLAMPED = 15  # seq_model_clamped's last position, where F2's write lands


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run(tmp_path_factory, CASES, checks=("f10",))


def _f32(x):
    """A kept cache leaf as float32 (bf16 leaves travel as their bits)."""
    return (x.astype(np.uint32) << 16).view(np.float32) if x.dtype == np.uint16 else x


def _leaves(got, prefix, step):
    out, j = [], 0
    while f"{prefix}/cache{step}/{j}" in got:
        out.append(_f32(got[f"{prefix}/cache{step}/{j}"]))
        j += 1
    return out


def _attn(name, leaves):
    """The attention entries among a case's cache leaves: each (k, v) pair,
    first in the leaves' order for every family ('attn' sorts before
    'ssm', 'cross' before 'self')."""
    return leaves[:2 * len(tmodel.attn_cache_keys(get_smoke_config(CASES[name][0])))]


@pytest.mark.parametrize("name", list(CASES))
def test_split_kv_serving_matches_the_jax_package(results, name):
    """The fed logits within ``LOGITS`` of the JAX package's sharded run on
    every rank (the same on all, all finite), and the port's greedy tokens
    equal where the JAX margin exceeds ``OWN``; ``seq_model_clamped``'s
    prefill logits only (F11)."""
    j = results["jax"]
    want, margins = j[f"{name}/logits"], j[f"{name}/margins"]
    steps = 1 if name == "seq_model_clamped" else STEPS
    for r, got in results[4].items():
        lg = got[f"{name}/logits"]
        assert lg.shape == want.shape and np.isfinite(lg).all()
        gaps = [logit_gap(lg[:, i], want[:, i]) for i in range(steps)]
        assert max(gaps) <= LOGITS[name], (r, gaps)
        np.testing.assert_array_equal(lg, results[4][0][f"{name}/logits"])
        tokens_where_margin(got[f"{name}/tokens"][:, :steps], j[f"{name}/tokens"][:, :steps],
                            margins[:, :steps], OWN[name])
    assert tokens_where_margin(results[4][0][f"{name}/tokens"][:, :steps],
                               j[f"{name}/tokens"][:, :steps], margins[:, :steps],
                               OWN[name]) >= 1


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_cache_blocks(results, name):
    """Every attention leaf on every rank is its pspec's block of the global
    cache (the layout ``decode_layout`` gives at the global batch and
    length), none whole where the pspec splits it over an axis larger than
    1, and the sequence split into ``SEQ_SPLIT`` blocks."""
    for r, got in results[4].items():
        assert got[f"{name}/cache_wrong"].tolist() == [""], (r, got[f"{name}/cache_wrong"])
        assert set(got[f"{name}/cache_seq_split"].tolist()) == {SEQ_SPLIT[name]}, r


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_cache_matches_the_jax_package(results, name):
    """After every decode step the port's cache, gathered from the ranks'
    blocks (``common.unshard``), is the JAX package's sharded cache within
    ``CACHE``: the prompt's entries, the steps' writes and the zero padding
    (``seq_model_clamped``: every position but F11's)."""
    j = results["jax"]
    for step in range(STEPS - 1):
        want = _leaves(j, name, step)
        for r, got in results[4].items():
            mine = _leaves(got, name, step)
            assert len(mine) == len(want)
            for a, b in zip(_attn(name, mine), _attn(name, want)):
                assert a.shape == b.shape, (r, step)
                if name == "seq_model_clamped":
                    a, b = np.delete(a, CLAMPED, axis=-3), np.delete(b, CLAMPED, axis=-3)
                gap = float(np.abs(a - b).max())
                assert gap <= CACHE[name], (r, step, gap)


@pytest.mark.parametrize("name", list(CASES))
def test_split_kv_is_exact_in_float32(results, name):
    """In float32 compute the split-KV decode on every rank gives the
    one-device run's logits within ``F32`` of its largest logit, and its
    gathered attention caches within 1e-5 of their largest entry."""
    for r, got in results[4].items():
        want = got[f"{name}/f32_plain_logits"]
        gap = logit_gap(got[f"{name}/f32_logits"], want)
        assert gap <= F32[name] * float(np.abs(want).max()), (r, gap)
        for step in range(STEPS - 1):
            for a, b in zip(_attn(name, _leaves(got, f"{name}/f32", step)),
                            _attn(name, _leaves(got, f"{name}/f32_plain", step))):
                assert a.shape == b.shape
                assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max()), (r, step)


def test_f2_clamped_write_lands_on_the_rank_that_holds_it_f11(results):
    """ROADMAP F2 and F11 at seq_model_clamped (no room past the 16-token
    prompt, the sequence over 'model' in blocks of 8): the JAX package's
    unsharded decode overwrites position 15 at every step, its sharded
    decode keeps the prompt's entry there (F11: the write is dropped); the
    port's write lands on model rank 1, which holds position 15, at every
    step, and in float32 its entry is the one-device run's."""
    name, j, got = "seq_model_clamped", results["jax"], results[4][0]
    at = lambda prefix, step, side=j: [x[..., CLAMPED, :, :]
                                       for x in _attn(name, _leaves(side, prefix, step))]
    prompt = at(name, -1)
    seen = []
    for step in range(STEPS - 1):
        for leaf, (first, sharded, plain, port, p32, one32) in enumerate(zip(
                prompt, at(name, step), at(f"{name}/plain", step), at(name, step, got),
                at(f"{name}/f32", step, got), at(f"{name}/f32_plain", step, got))):
            assert np.array_equal(sharded, first), (step, leaf)  # F11: dropped
            assert not np.array_equal(plain, first), (step, leaf)  # F2: overwritten
            assert not np.array_equal(port, first), (step, leaf)
            assert float(np.abs(p32 - one32).max()) <= 1e-5 * float(np.abs(one32).max())
        seen.append(at(name, step, got)[0])
    assert all(not np.array_equal(a, b) for a, b in zip(seen, seen[1:]))  # each step's token


def test_f10_pspec_cannot_be_placed(results):
    """ROADMAP F10: qwen3-1.7b's smoke cache at ``ShapeConfig("p", 18, 4,
    "decode")`` and tp = 2 gets the pspec P(None, None, 'data', 'model',
    None) from both packages' ``cache_specs`` (18 divides the 'model' size
    it is tested against); on a (data, model) = (4, 2) mesh
    ``jax.device_put`` refuses it, and the port's ``decode_layout``
    refuses it with the same substance."""
    j = results["jax"]
    cfg = get_smoke_config("qwen3-1.7b")
    shape = ShapeConfig("p", 18, 4, "decode")
    sds, pss = tmodel.cache_specs(cfg, shape, tp=2)
    assert str(pss["layers"][0]) == "P(None, None, 'data', 'model', None)"
    assert str(j["f10/pspec"]) == "PartitionSpec(None, None, 'data', 'model', None)"
    substance = ("the global size of its dimension 2 should be divisible by 4, but it is "
                 "equal to 18 (full shape: (2, 4, 18, 2, 16))")
    assert substance in str(j["f10/message"])
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 2))
    with pytest.raises(ValueError, match=substance.replace("(", r"\(").replace(")", r"\)")):
        tmodel.decode_layout(tmodel.build(cfg, tp=2), mesh, 4, 18)


def _combine(q, k, v, length, blocks, drop=()):
    """The split read run block by block in one process: ``layers``' block
    functions on ``blocks`` equal blocks of the positions, the max and the
    sums over blocks standing in for the collectives (the output's sum in
    float32, rounded once, as ``mesh.all_reduce`` sums 16-bit floats; the
    sums in block order, chip_smoke.py's ``combine_blocks``).
    ``drop``: blocks left out."""
    n = k.shape[1] // blocks
    keep = [i for i in range(blocks) if i not in drop]
    parts = [L.block_scores(q, k[:, i * n:(i + 1) * n], i * n, length) for i in keep]
    gmax = functools.reduce(torch.maximum, [m for _, m in parts])
    wts = [L.block_weights(s, m, gmax) for s, m in parts]
    total = functools.reduce(torch.add, [t for _, t in wts])
    outs = [L.block_output(w, t, total, v[:, i * n:(i + 1) * n], q.dtype).float()
            for i, (w, t) in zip(keep, wts)]
    return functools.reduce(torch.add, outs).to(q.dtype)


def _qkv(seed=0, b=2, hq=8, hkv=2, s=48, dh=16, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, generator=g).to(dtype)
    return mk(b, 1, hq, dh), mk(b, s, hkv, dh), mk(b, s, hkv, dh)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_block_combine_matches_whole_attention(blocks):
    """One block is ``_grouped_decode_attention`` bit for bit; 2 and 4
    blocks are within two bf16 roundings of it (2^-6 of the largest output:
    each block's weights round to bf16 at another scale, then the output),
    and in float32 within 1e-6 of it."""
    q, k, v = _qkv()
    length = 37  # the last block past it in part
    want = _grouped_decode_attention(q, k, v, length)
    got = _combine(q, k, v, length, blocks)
    if blocks == 1:
        assert torch.equal(got, want)
    else:
        assert float((got.float() - want.float()).abs().max()) <= 2 ** -6 * float(
            want.float().abs().max())
    q32, k32, v32 = (t.float() for t in (q, k, v))
    gap = (_combine(q32, k32, v32, length, blocks) - _grouped_decode_attention(
        q32, k32, v32, length)).abs().max()
    assert float(gap) <= 1e-6


def test_block_combine_wholly_masked_block_adds_zero():
    """A block wholly past ``length`` adds exactly 0 (no NaN from its
    ``-inf - -inf``): the result equals the combine without that block."""
    q, k, v = _qkv(seed=1)
    got = _combine(q, k, v, 20, 4)  # blocks of 12: blocks 2 and 3 wholly masked
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, _combine(q, k, v, 20, 4, drop=(2, 3)))
