"""The benchmark of amv_tpu_torch, the PyTorch and CUDA port: see
portbench/run.py and BENCHMARK.json at the repository's root."""
