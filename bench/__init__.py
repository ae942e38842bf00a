"""The benchmark of `repro_torch`, the PyTorch and CUDA port, on one
NVIDIA H100: `python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`. `BENCHMARK.json` at the repository's root
names its cells and metrics; everything a cell, a configuration or a
metric needs is found here by name."""
