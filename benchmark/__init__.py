"""The benchmark of the PyTorch and CUDA port (`cyclistsocialforce_tpu_torch`):
`run.py` runs one cell of `BENCHMARK.json` once (see README.md)."""
