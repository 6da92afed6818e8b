"""Spiking-neural-network subsystem of the port (counterpart of
``repro.snn``): LIF pools, the SNN-to-VP mapping and the rate-coded
inference jobs (feed-forward, wide, recurrent and skip) with their CPU
oracle, spike-rate profiling and traffic-aware placement, and hybrid jobs
(live RISC-V CPUs injecting spikes and reading counts back beside a dense
offload: ``hybrid_job`` -> ``build_hybrid`` -> ``Controller.run`` ->
``hybrid_results``); ``FaultConfig`` and
``degradation_sweep`` (``repro_torch.faults``) are re-exported here, as the
reference does."""
from repro_torch.faults import FaultConfig, degradation_sweep
from repro_torch.snn.neuron import LIFParams, lif_step, lif_step_multi, pool_state
from repro_torch.snn.topology import (
    RecurrentEdge,
    SNNLayer,
    StripeGroup,
    auto_segmentation_for,
    build_hybrid,
    build_snn,
    connectivity,
    consumed_rates,
    edge_dsts,
    hybrid_results,
    is_cyclic,
    layer_groups,
    layer_spikes,
    measure_traffic,
    n_units_for,
    output_spike_counts,
    profile_traffic,
    segmentation_for,
    total_spikes,
)
from repro_torch.snn.workloads import (
    HybridJob,
    SNNJob,
    hybrid_job,
    oracle_rates,
    oracle_run,
    random_recurrent_snn,
    random_snn,
    rate_encode,
    snn_inference_job,
    snn_recurrent_job,
    snn_skip_job,
)
