"""Benchmark of the PyTorch/CUDA port: python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>."""
