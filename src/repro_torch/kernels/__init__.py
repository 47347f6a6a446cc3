"""The port's kernels: ``ops`` (backend dispatch), ``ref`` (plain PyTorch
versions), and one module per hand-written CUDA kernel (``conv2d``,
``maxpool``, ``resize``, ``pointwise`` — with RMSNorm —, ``qmatmul`` —
with the float-activation, int8-activation and per-group quantized
matmuls —, ``attention`` and ``decode_attention``), each wrapper with
its launch counter."""
