"""bigdl_tpu_torch — the PyTorch + CUDA port of ``bigdl_tpu``.

The package mirrors ``bigdl_tpu``'s module paths and public names so a
reader finds each counterpart one to one, but it is self-contained: it
imports ``torch`` and numpy, never ``jax`` and nothing of ``bigdl_tpu``
(``tests/test_torch_isolation.py`` pins both in a fresh interpreter).

What is ported so far is the int8-KV continuous-batching serving path
of :func:`bigdl_tpu_torch.models.transformer.TransformerLM`:
``ServingEngine.submit`` → bucketed batched prefill → pooled per-row
decode with the fused per-row sampler → ``drain``. Its one TPU kernel,
the pooled decode attention, is a hand-written CUDA kernel
(``csrc/decode_attention.cu``) built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise
(:func:`bigdl_tpu_torch.utils.device.resolve_device`).
"""
