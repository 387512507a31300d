"""consbench: the benchmark of abpoa_tpu_torch (the port's PyTorch and
CUDA engine). ``python consbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``."""
