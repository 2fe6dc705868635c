"""Optimization-side helpers of the port (``bigdl_tpu.optim`` counterparts)."""
