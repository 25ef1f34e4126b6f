"""The kNN, CF and LSH kernels: hand-written CUDA for Hopper, plain PyTorch
versions in ``ref``, device dispatch in ``ops``."""
