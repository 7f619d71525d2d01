"""The benchmark of ``vanerf_tpu_torch`` on NVIDIA H100 cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Configurations
(``configs/``), their model families (``families/``: the reference, the
weight skeleton, the FLOP counts), traffic mixes (``traffic/``), per-layer
metric readers (``metrics/``) and the output check's limits (``limits/``)
are found by the names the manifest and the configurations give them; the
inputs (``inputs.py``), the weights (``weights.py``), the FLOP counts
(``flops.py``, ``peaks.json``) and the plain reference (``reference/``)
belong to the benchmark, not to the program.
"""
