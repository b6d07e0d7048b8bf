"""The benchmark of ``ldpcgputegra_tpu_torch`` on one NVIDIA H100.

``python3 bench_port/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once
and prints one JSON line; ``bench_port/README.md`` says how cells,
traffic mixes and metrics are added as files.
"""
