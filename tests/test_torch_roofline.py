"""The port's FLOP accounting (``repro_torch.analysis.roofline``) against the
JAX package's: ``active_params`` and ``model_flops`` for all ten
architectures, full and smoke, the ``Roofline`` terms with the H100's
constants, and ``from_step`` on a matmul whose FLOPs and bytes are known."""
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.common import param_count as jparam_count
from repro.configs import base as jbase
from repro.models import model as jmodel
from repro_torch.analysis import roofline as roof
from repro_torch.common import param_bytes, param_count
from repro_torch.configs import base
from repro_torch.models import model

# llama4-scout's 40 query heads, padded to 48 by the reference's default
# tp = 16: 8 padded heads of head_dim 128 in wq and wo, over 48 layers
LLAMA4_PADDED_HEADS = 503_316_480
CASES = [(arch, smoke) for arch in base.ARCH_IDS for smoke in (False, True)]
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _configs(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    return getattr(base, get)(arch), getattr(jbase, get)(arch)


def _jax_active_at_tp1(jcfg):
    """The JAX package's active count of the model built at tp = 1, with
    ``active_params``' expert correction."""
    total = jparam_count(jmodel.build(jcfg, tp=1).specs)
    if jcfg.moe is None:
        return total
    mo = jcfg.moe
    per_expert = 3 * jcfg.d_model * mo.d_ff_expert
    return total - (jcfg.n_layers - mo.first_k_dense) * (mo.n_experts - mo.top_k) * per_expert


@pytest.mark.parametrize("arch,smoke", CASES)
def test_active_params_and_model_flops_equal_jax(arch, smoke):
    cfg, jcfg = _configs(arch, smoke)
    got = roof.active_params(cfg)
    assert got == _jax_active_at_tp1(jcfg)
    want = jroof.active_params(jcfg)  # built at the reference's tp = 16
    if arch == "llama4-scout-17b-a16e" and not smoke:
        assert want - got == LLAMA4_PADDED_HEADS
    else:
        assert got == want
    for kind, shape in KINDS.items():
        want_f = jroof.model_flops(jcfg, jbase.SHAPES[shape], kind) * got / want
        assert roof.model_flops(cfg, base.SHAPES[shape], kind) == pytest.approx(want_f, rel=1e-12)


def test_param_count_and_bytes_of_the_spec_tree():
    cfg, jcfg = _configs("qwen3-1.7b", True)
    specs = model.build(cfg).specs
    jspecs = jmodel.build(jcfg, tp=1).specs
    from repro.common import param_bytes as jparam_bytes

    assert param_count(specs) == jparam_count(jspecs)
    assert param_bytes(specs) == jparam_bytes(jspecs)


def test_roofline_terms_and_bottleneck():
    r = roof.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 2.0) < 1e-9
    assert r.t_collective == 0.0 and r.t_bound == r.t_memory
    assert r.bottleneck == "memory"
    r = roof.Roofline(flops=989e12 * 3, bytes_accessed=3.35e12)
    assert r.bottleneck == "compute" and abs(r.t_bound - 3.0) < 1e-9
    assert set(r.to_dict()) == set(jroof.Roofline(1.0, 1.0, 0.0).to_dict())
    with pytest.raises(ValueError, match="no collective term"):
        roof.Roofline(flops=1.0, bytes_accessed=1.0, coll_bytes=8.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_step_counts_a_matmul(dtype):
    a = torch.randn(64, 32, dtype=dtype)
    b = torch.randn(32, 16, dtype=dtype)
    r = roof.from_step(lambda x, y: (x @ y.t().t()).t(), a, b)
    assert r.flops == 2 * 64 * 32 * 16
    # the matmul reads a and b and writes the product; the transposes are views
    assert r.bytes_accessed == (64 * 32 + 32 * 16 + 64 * 16) * a.element_size()
    assert r.coll_detail == {"aten_ops": 1}
    assert r.bottleneck == "memory"


def test_from_step_counts_backward_and_elementwise_bytes():
    w = torch.randn(32, 16, requires_grad=True)
    x = torch.randn(8, 32)

    def step():
        (torch.relu(x @ w)).sum().backward()

    r = roof.from_step(step)
    # forward matmul, and the weight gradient's in backward (x needs none)
    assert r.flops == 2 * (2 * 8 * 32 * 16)
    assert r.bytes_accessed > (8 * 32 + 32 * 16 + 8 * 16) * 4

