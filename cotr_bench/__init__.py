"""The benchmark of the PyTorch and CUDA port (``cotr_tpu_torch``) on one
NVIDIA card: ``python3 -m cotr_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
