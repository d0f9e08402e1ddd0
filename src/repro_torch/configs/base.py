"""Architecture registry: one module per assigned arch, each exposing

* ``SPEC``    — full-size :class:`repro_torch.core.ModelSpec` (exact
  assignment),
* ``SMOKE``   — reduced same-family spec for CPU tests,
* ``RUNTIME`` — :class:`repro_torch.models.common.RuntimeCfg`,
* ``SHAPES``  — which workload shapes apply (+ skip reasons).

``--arch <id>`` everywhere resolves through :func:`get`, which returns every
arch of ``ARCHS``: the generator (``Scenario``, sweeps, the prover, the
``python -m repro_torch.analysis`` CLI) runs them all.  ``PORTED`` names the
archs the port also *serves* (``models/``, ``launch/serve.py``): all ten.

Own copy of ``repro.configs.base``.
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
# the archs the port serves (models/, launch/serve.py)
PORTED = ARCHS


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling (see DESIGN.md
# §Shape-applicability): run only for SSM / hybrid / sliding-window archs.
LONG_OK = {"rwkv6-7b", "jamba-v0.1-52b", "gemma2-27b"}


@dataclass(frozen=True)
class Arch:
    name: str
    spec: ModelSpec
    smoke: ModelSpec
    runtime: RuntimeCfg
    skip: dict            # shape name -> reason (absent = runs)

    def shapes(self):
        for s in SHAPES.values():
            if s.name not in self.skip:
                yield s


def get(name: str) -> Arch:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    mod = importlib.import_module(
        f"{__package__}." + name.replace("-", "_").replace(".", "_"))
    skip = dict(getattr(mod, "SKIP", {}))
    if name not in LONG_OK and "long_500k" not in skip:
        skip["long_500k"] = ("pure full-attention decoder: 524k dense-KV "
                             "decode skipped per assignment")
    return Arch(name=name, spec=mod.SPEC, smoke=mod.SMOKE,
                runtime=getattr(mod, "RUNTIME", RuntimeCfg()), skip=skip)


def all_archs():
    return [get(a) for a in ARCHS]
