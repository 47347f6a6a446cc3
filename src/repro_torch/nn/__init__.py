"""LM building blocks over plain nested dicts of tensors: ``layers``
(linear, norms, embeddings, RoPE, MLP), ``attention`` (GQA attention
with prefill and cached decode), and the ``moe``/``ssm`` config
dataclasses."""
