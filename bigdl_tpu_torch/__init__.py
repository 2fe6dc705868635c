"""bigdl_tpu_torch — the PyTorch + CUDA port of ``bigdl_tpu``.

The package mirrors ``bigdl_tpu``'s module paths and public names so a
reader finds each counterpart one to one, but it is self-contained: it
imports ``torch`` and numpy, never ``jax`` and nothing of ``bigdl_tpu``
(``tests/test_torch_isolation.py`` pins both in a fresh interpreter).

What is ported so far: the int8-KV continuous-batching serving path
of :func:`bigdl_tpu_torch.models.transformer.TransformerLM`
(``ServingEngine.submit`` → bucketed batched prefill → pooled per-row
decode → ``drain``) with the pooled decode-attention kernel
(``csrc/decode_attention.cu``); its training through
``Optimizer.optimize()`` with the flash-attention kernels
(``csrc/flash_attention.cu``); and ResNet-50 training through
``optimize()``, fused by :func:`bigdl_tpu_torch.nn.tpu_fusion.maybe_fuse`
into BN → ReLU → 1×1-conv kernels (``csrc/fused_conv.cu``). Every kernel
is hand-written CUDA, built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise
(:func:`bigdl_tpu_torch.utils.device.resolve_device`).
"""
