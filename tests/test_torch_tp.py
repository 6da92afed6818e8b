"""Tensor parallelism over 'model' (ROADMAP item 14) against the JAX package's
GSPMD runs: one smoke configuration of each family served on (data, model)
= (2, 2) at tp = 2, the JAX side jitted over 4 of 8 fake devices
(``conftest.run_with_devices``) with ``in_shardings`` of the specs'
shardings, the port's side in a gloo world of 4 CPU processes, each rank
on its blocks (``tests/tp_parity.py`` runs both sides; a rank's log is
``rank<r>.log`` in the test's temporary directory).

Each case: the prefill's last-position logits and three decode steps'
logits (each step fed the JAX package's greedy token), gathered over the
ranks; the port's own greedy tokens (``greedy_generate(mesh=)``, the
argmax combined over the vocab blocks); and every rank's blocks of the
weights (``run_pspecs``): ``common.shard``'s block of each leaf, none whole
where its spec names 'model', the rank's bytes below the model's.

Bounds (``LOGITS``): twice the JAX package's own largest distance between
its sharded and unsharded runs over the four positions (the unsharded run
fed the sharded run's tokens), measured on these inputs with jax 0.9 on a
CPU: qwen3-1.7b 0.0039, kimi-k2 0.48, qwen2-vl 0.125, falcon-mamba-7b
0.0039, zamba2-2.7b 0.133, whisper-tiny 0.135 (F3's near-one-hot softmax
rows).  The port against the JAX package's sharded run, the same
measurement with torch 2.13: 2.4e-7, 0.0625, 1.9e-6, 0.0078 (one bf16 ulp
at a logit of 1.3), 0, 0.145.  Greedy tokens are compared where the JAX
package's top-1/top-2 margin exceeds its own distance (``OWN``): 15, 3, 11,
16, 10 and 1 of the 16 positions.

Those bounds carry bf16 rounding (kimi-k2's and whisper-tiny's are wide),
so every case also runs in float32 compute on the mesh and on one device
(``tp_parity``): the fed logits within ``F32`` of the largest logit, the
tensor-parallel arithmetic's own check.  Measured (torch 2.13, a CPU):
3.6e-7, 2.5e-6, 1.3e-6, 2.7e-7, 1.3e-6 and 2.7e-5 of it; each bound is 1e-5,
whisper-tiny's 5e-5 (F3's near-one-hot softmax rows magnify a float32
rounding as they magnify a bf16 one).
"""
import numpy as np
import pytest

from tp_parity import logit_gap, run

CASES = {
    "dense": ("qwen3-1.7b", (2, 2), {}),
    "moe": ("kimi-k2-1t-a32b", (2, 2), {}),
    "vlm": ("qwen2-vl-72b", (2, 2), {}),
    "ssm": ("falcon-mamba-7b", (2, 2), {}),
    "hybrid": ("zamba2-2.7b", (2, 2), {}),
    "encdec": ("whisper-tiny", (2, 2), {}),
}
# the JAX package's own sharded-vs-unsharded logit distance (the module's
# docstring); the logits are held at twice it
OWN = {"dense": 0.00390625, "moe": 0.48046875, "vlm": 0.125, "ssm": 0.00390625,
       "hybrid": 0.1328125, "encdec": 0.134765625}
LOGITS = {k: 2 * v for k, v in OWN.items()}
F32 = {k: 5e-5 if k == "encdec" else 1e-5 for k in CASES}  # of the largest logit


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run(tmp_path_factory, CASES)


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


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_serving_matches_the_jax_package_sharded(results, name):
    """Prefill and decode logits within ``LOGITS`` of the JAX package's
    sharded run on every rank (the same on all), and the port's greedy
    tokens equal where its margin exceeds ``OWN``."""
    j = results["jax"]
    want, margins = j[f"{name}/logits"], j[f"{name}/margins"]
    for r, got in results[4].items():
        lg = got[f"{name}/logits"]
        assert lg.shape == want.shape and np.isfinite(lg).all()
        gaps = [logit_gap(lg[:, i], want[:, i]) for i in range(lg.shape[1])]
        assert max(gaps) <= LOGITS[name], (r, gaps)
        np.testing.assert_array_equal(lg, results[4][0][f"{name}/logits"])
        tokens_where_margin(got[f"{name}/tokens"], j[f"{name}/tokens"], margins, OWN[name])
    assert tokens_where_margin(results[4][0][f"{name}/tokens"], j[f"{name}/tokens"], margins,
                               OWN[name]) >= 1


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_spec_blocks(results, name):
    """Every leaf is ``common.shard``'s block of its run pspec, none whole
    where its spec names 'model', and a rank holds less than the model."""
    for r, got in results[4].items():
        assert got[f"{name}/wrong"].tolist() == [""], (r, got[f"{name}/wrong"])
        held, whole = got[f"{name}/bytes"].tolist()
        assert whole / 2 <= held < whole, (r, held, whole)


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_serving_is_exact_in_float32(results, name):
    """In float32 compute the tensor-parallel prefill and decode logits on
    every rank are the one-device run's within ``F32`` of its largest
    logit."""
    for r, got in results[4].items():
        want = got[f"{name}/f32_plain_logits"]
        gap = logit_gap(got[f"{name}/f32_logits"], want)
        assert gap <= F32[name] * float(np.abs(want).max()), (r, gap)
