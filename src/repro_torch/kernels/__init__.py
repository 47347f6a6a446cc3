"""The port's kernels: ``ops`` (backend dispatch), ``ref`` (plain PyTorch
versions), and one module per hand-written CUDA kernel (``conv2d``,
``maxpool``, ``resize``, ``pointwise``, ``qmatmul`` — the last with the
float-activation, int8-activation and per-group quantized matmuls), each
wrapper with its launch counter."""
