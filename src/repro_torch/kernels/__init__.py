"""The port's kernels: ``ops`` (backend dispatch), ``ref`` (plain PyTorch
versions), and one module per hand-written CUDA kernel (``conv2d``,
``maxpool``, ``resize``, ``pointwise``), each with its launch counter."""
