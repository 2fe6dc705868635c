"""Model builders of the port (``bigdl_tpu.models`` counterparts)."""

import importlib

#: the models this package exports, by module; imported on first use,
#: so that ``python -m bigdl_tpu_torch.models.rnn`` runs its module once
_EXPORTS = {"AlexNet": "alexnet", "AlexNet_OWT": "alexnet",
            "PTBModel": "rnn", "SimpleRNN": "rnn",
            "BinaryTreeLSTM": "treelstm", "TreeLSTMSentiment": "treelstm"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
