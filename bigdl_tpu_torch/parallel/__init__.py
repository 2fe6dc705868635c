"""bigdl_tpu_torch.parallel — the distributed parameter and communication
plane of the port (``bigdl_tpu/parallel/``): the partitioned parameter
vector and its collectives (``all_reduce.py``), the model broadcast
(``broadcast.py``), and the block stores with their array codec and the
block-store gradient exchange with the straggler drop
(``block_store.py``)."""

from bigdl_tpu_torch.parallel.all_reduce import (
    AllReduceParameter, flatten_params,
)
from bigdl_tpu_torch.parallel.block_store import (
    BlockStore, BlockStoreParameter, CoordServiceBlockStore, FsBlockStore,
    GradientDropPolicy, MemBlockStore, decode_array, default_block_store,
    encode_array,
)
from bigdl_tpu_torch.parallel.broadcast import ModelBroadcast

__all__ = ["AllReduceParameter", "flatten_params", "ModelBroadcast",
           "BlockStore", "BlockStoreParameter", "CoordServiceBlockStore",
           "FsBlockStore", "GradientDropPolicy", "MemBlockStore",
           "default_block_store", "encode_array", "decode_array"]
