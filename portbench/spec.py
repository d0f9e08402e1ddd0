"""A configuration file's ``port`` section as the port's ``ModelSpec`` and
``RuntimeCfg``: the only place the harness names the program's types."""
from __future__ import annotations


def port_spec(cfg: dict):
    from repro_torch.core import MLASpec, ModelSpec, MoESpec, SSMSpec
    kw = dict(cfg["port"]["spec"])
    for key, typ in (("moe", MoESpec), ("ssm", SSMSpec), ("mla", MLASpec)):
        if key in kw:
            kw[key] = typ(**kw[key])
    return ModelSpec(**kw)


def runtime(cfg: dict):
    from repro_torch.models.common import RuntimeCfg
    return RuntimeCfg(param_dtype=cfg["served_dtype"],
                      compute_dtype=cfg["served_dtype"], attention_impl="cuda",
                      moe_capacity=cfg["assumed"]["moe_capacity_factor"])
