"""Transforms of the port (``bigdl_tpu/transform``): ``vision``."""
