"""Runtime models of the port: dense GQA decoders, MLA and MoE (deepseek),
RWKV6, the Mamba hybrid (jamba), the encoder-decoder (whisper) and the
vision prefix (internvl2): all ten architectures of ``configs``."""
from . import layers, lm
from .common import AxisRules, Initializer, RuntimeCfg, constrain
from .convert import params_from_reference
from .lm import (decode_step, forward, init_cache, init_params, loss_fn,
                 param_axes)

__all__ = ["layers", "lm", "AxisRules", "Initializer", "RuntimeCfg",
           "constrain", "decode_step",
           "forward", "init_cache", "init_params", "loss_fn", "param_axes",
           "params_from_reference"]
