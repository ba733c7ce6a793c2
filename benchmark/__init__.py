"""The benchmark of the PyTorch/CUDA port; ``python3 -m benchmark.run``."""
