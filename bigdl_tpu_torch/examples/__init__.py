"""Runnable examples of the port (``bigdl_tpu/examples`` counterparts):
``distributed_pod``, data-parallel training through ``DistriOptimizer``."""
