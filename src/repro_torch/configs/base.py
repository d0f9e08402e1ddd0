"""Architecture registry of the port: one module per ported arch, each
exposing

* ``SPEC``    — full-size :class:`repro_torch.core.ModelSpec`,
* ``SMOKE``   — reduced same-family spec for CPU tests,
* ``RUNTIME`` — :class:`repro_torch.models.common.RuntimeCfg`.

``ARCHS`` lists every architecture of the JAX package so the gap shows;
``PORTED`` the ones this package runs.  ``--arch <id>`` resolves through
:func:`get`, which raises for a name that is not ported yet.  The workload
shapes (``SHAPES``) belong to the training and dry-run launchers and come with
them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..core import ModelSpec
from ..models.common import RuntimeCfg

ARCHS = (
    "granite-34b", "gemma2-27b", "qwen3-14b", "minitron-8b", "whisper-medium",
    "deepseek-moe-16b", "deepseek-v2-236b", "internvl2-26b", "jamba-v0.1-52b",
    "rwkv6-7b",
)
PORTED = ("qwen3-14b", "rwkv6-7b")


@dataclass(frozen=True)
class Arch:
    name: str
    spec: ModelSpec
    smoke: ModelSpec
    runtime: RuntimeCfg


def get(name: str) -> Arch:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (ported: "
            f"{PORTED}); see ROADMAP.md queue 1.  The JAX package `repro` "
            "runs it")
    mod = importlib.import_module(
        f"{__package__}." + name.replace("-", "_").replace(".", "_"))
    return Arch(name=name, spec=mod.SPEC, smoke=mod.SMOKE,
                runtime=getattr(mod, "RUNTIME", RuntimeCfg()))
