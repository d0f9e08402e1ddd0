"""Training of the port: AdamW with fp32 moments, top-k gradient
compression with error feedback, and the train step (own copy of
``repro.train``, in PyTorch), with ZeRO-1 ``opt_state_shardings`` for a
state placed on a mesh."""
from .compress import topk_compress_decompress
from .optimizer import (OptCfg, adamw_update, init_opt_state,
                        opt_state_shardings)
from .train_step import make_train_step

__all__ = ["OptCfg", "adamw_update", "init_opt_state", "make_train_step",
           "opt_state_shardings", "topk_compress_decompress"]
