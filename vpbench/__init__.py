"""The port's benchmark: simulation jobs of ``repro_torch``'s virtual
platform on one NVIDIA card.  ``python3 vpbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints one JSON line (see ``run.py``)."""
