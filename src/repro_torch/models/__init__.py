"""Runtime models of the port (dense GQA decoders and RWKV6 so far)."""
from . import layers, lm
from .common import Initializer, RuntimeCfg
from .convert import params_from_reference
from .lm import decode_step, forward, init_cache, init_params

__all__ = ["layers", "lm", "Initializer", "RuntimeCfg", "decode_step",
           "forward", "init_cache", "init_params", "params_from_reference"]
