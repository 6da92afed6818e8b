"""The benchmark's frozen copies against what they copy: the input
generators give the port's builders the port's exact inputs, the plain
references agree with the port's oracle and with ``A @ B``, and the bound
arithmetic is ``chip_smoke.py``'s."""
import dataclasses

import numpy as np
import pytest
import torch

from vpbench import bounds, gen, reference


@pytest.mark.parametrize("sizes", [(16, 12, 8), (64, 48, 10), (256, 256, 256)])
def test_snn_job_draws_are_the_ports(sizes):
    from repro_torch.snn import workloads as swl

    for seed in (0, 5, gen.seed_of(2**31 + 3, 17)):
        mine = gen.snn_job(sizes, 12, 0.5, seed)
        theirs = swl.snn_inference_job(sizes, t_steps=12, rate=0.5, seed=seed)
        assert np.array_equal(mine.raster, theirs.raster)
        assert len(mine.layers) == len(theirs.layers)
        for (w, thresh, leak), layer in zip(mine.layers, theirs.layers):
            assert np.array_equal(w, layer.weights) and w.dtype == layer.weights.dtype
            assert (thresh, leak, 0) == (layer.params.thresh, layer.params.leak,
                                         layer.params.refrac_period)
        assert mine.n_ticks == len(mine.raster) + len(sizes)
    x = np.linspace(0, 1, 40)
    assert np.array_equal(gen.rate_encode(x, 9, 3), swl.rate_encode(x, 9, seed=3))


def test_dense_draws_are_the_ports():
    from repro_torch.vp import workloads as wl

    assert [dataclasses.astuple(layer) for layer in gen.TABLE_III] == \
        [dataclasses.astuple(layer) for layer in wl.TABLE_III]
    for layer in gen.TABLE_III[:2]:
        for seed in (0, 9, gen.seed_of(2**31 + 1, 0)):
            ga = gen.layer_data(gen.Layer(*dataclasses.astuple(layer)), seed)
            wa = wl.layer_data(layer, seed)
            assert all(np.array_equal(x, y) for x, y in zip(ga, wa))
            mine, theirs = gen.dram_image(layer, *ga[:2]), wl.dram_image(layer, *wa[:2])
            assert np.array_equal(mine[0], theirs[0]) and mine[1:] == theirs[1:]
    assert gen.A_BASE_W == wl.A_BASE_W


@pytest.mark.parametrize("sizes,t_steps", [((16, 12, 8), (4, 6, 9)), ((64, 48, 10), (12, 8, 5)),
                                           ((256, 256, 256), (24, 12, 8))])
def test_lif_reference_agrees_with_the_ports_oracle(sizes, t_steps):
    from repro_torch.snn import workloads as swl

    jobs = [gen.snn_job(sizes, t_steps[i % 3], 0.5, 40 + i) for i in range(6)]
    counts, per_layer = reference.lif_chain(jobs, block=4)
    for k, job in enumerate(jobs):
        theirs = swl.snn_inference_job(sizes, t_steps=len(job.raster), rate=0.5, seed=40 + k)
        assert np.array_equal(counts[k], theirs.expected_counts)
        _, totals = swl.oracle_run(theirs.layers, theirs.raster)
        assert np.array_equal(per_layer[k], totals)


def test_vmm_reference_is_a_at_b():
    a, b, o = gen.layer_data(gen.TABLE_III[0], 3)
    assert np.array_equal(reference.vmm(a, b), o)


def test_tick_bytes_are_chip_smokes():
    import chip_smoke

    for s, n, n_fire in ((128, 2, 128), (4, 2, 3), (16, 2, 0)):
        cims = {"present": torch.ones(s, n, dtype=torch.bool)}
        fire = torch.zeros(s, n, dtype=torch.bool)
        fire.view(-1)[:n_fire] = True
        ms, _ = chip_smoke.tick_bound_ms(cims, fire)
        mine = bounds.tick_bytes(s * n, s, n_fire) / bounds.PEAK_BYTES_PER_S * 1e3
        assert mine == pytest.approx(ms, rel=1e-12)
    assert chip_smoke.PEAK_BYTES_PER_S == bounds.PEAK_BYTES_PER_S
    assert chip_smoke.PEAK_INT8_OPS_PER_S == bounds.PEAK_INT8_OPS_PER_S
