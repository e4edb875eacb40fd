"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100:
``python3 simbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, with the cells, metrics and bounds in BENCHMARK.json."""
