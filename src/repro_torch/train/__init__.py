"""Training of the port: AdamW with fp32 moments, top-k gradient
compression with error feedback, and the train step (own copy of
``repro.train``, in PyTorch).  ``opt_state_shardings`` waits for the
sharding slice."""
from .compress import topk_compress_decompress
from .optimizer import OptCfg, adamw_update, init_opt_state
from .train_step import make_train_step

__all__ = ["OptCfg", "adamw_update", "init_opt_state", "make_train_step",
           "topk_compress_decompress"]
