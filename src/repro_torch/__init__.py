"""PyTorch/CUDA port of the SATAY toolflow (the JAX package ``repro`` is
its reference).

The same toolflow — YOLO builders emitting one IR, rewrite passes, the
DSE and buffer plan, the design-rule checker, codegen and the serving
``Deployment`` — with every Pallas kernel of the float serving path
replaced by a hand-written CUDA kernel for Hopper (``csrc/``). Entry
points run on the card unless the caller names the CPU.

Layout mirrors ``repro``: ``core`` (ir, quant, passes, check, dse,
buffers, codegen, toolflow), ``kernels`` (ops dispatch, plain versions in
``ref``, one module per CUDA kernel), ``models.yolo``, ``serve``,
``data.synthetic``, ``roofline.hw``. The package imports torch, numpy and
the standard library only.
"""
