"""bigdl_tpu_torch.parallel — the host-side block stores of the port
(``bigdl_tpu/parallel/``): the self-describing array codec and the
in-process and shared-directory stores the serving plane's handoff wire
and host KV tier ride (``block_store.py``)."""

from bigdl_tpu_torch.parallel.block_store import (
    BlockStore, FsBlockStore, MemBlockStore, decode_array, encode_array,
)

__all__ = ["BlockStore", "MemBlockStore", "FsBlockStore", "encode_array",
           "decode_array"]
