"""Benchmark entry points of the port (``benchmarks/`` of the reference):
``python -m repro_torch.benchmarks.run --only kernels,stream``."""
