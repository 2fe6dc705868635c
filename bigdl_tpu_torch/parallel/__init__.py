"""bigdl_tpu_torch.parallel — the distributed parameter and communication
plane of the port (``bigdl_tpu/parallel/``): the partitioned parameter
vector and its collectives (``all_reduce.py``), the model broadcast
(``broadcast.py``), the block stores with their array codec and the
block-store gradient exchange with the straggler drop
(``block_store.py``), and the tensor, pipeline, sequence and expert
parallel functions over the axes of ``Engine.current_mesh()``
(``tensor_parallel.py``, ``pipeline.py``, ``ring_attention.py``,
``moe.py``; their collectives in ``axis.py``)."""

from bigdl_tpu_torch.parallel.all_reduce import (
    AllReduceParameter, flatten_params,
)
from bigdl_tpu_torch.parallel.block_store import (
    BlockStore, BlockStoreParameter, CoordServiceBlockStore, FsBlockStore,
    GradientDropPolicy, MemBlockStore, decode_array, default_block_store,
    encode_array,
)
from bigdl_tpu_torch.parallel.broadcast import ModelBroadcast
from bigdl_tpu_torch.parallel.moe import mlp_expert, moe_layer, top_k_gating
from bigdl_tpu_torch.parallel.pipeline import (
    gpipe, microbatch, stack_stage_params,
)
from bigdl_tpu_torch.parallel.ring_attention import (
    attention, ring_attention, stripe_sequence, striped_ring_attention,
    ulysses_attention, unstripe_sequence,
)
from bigdl_tpu_torch.parallel.tensor_parallel import (
    column_parallel_linear, row_parallel_linear, tp_attention, tp_mlp,
)

__all__ = ["AllReduceParameter", "flatten_params", "ModelBroadcast",
           "BlockStore", "BlockStoreParameter", "CoordServiceBlockStore",
           "FsBlockStore", "GradientDropPolicy", "MemBlockStore",
           "default_block_store", "encode_array", "decode_array",
           "attention", "ring_attention", "stripe_sequence",
           "striped_ring_attention", "ulysses_attention",
           "unstripe_sequence", "column_parallel_linear",
           "row_parallel_linear", "tp_mlp", "tp_attention", "gpipe",
           "microbatch", "stack_stage_params", "moe_layer", "top_k_gating",
           "mlp_expert"]
