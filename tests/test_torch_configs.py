"""The port's architecture registry (``repro_torch.configs``) against the
JAX package's: all ten archs, each module's ``SPEC``, ``SMOKE``,
``RUNTIME`` and ``SKIP`` as the reference has them, and the workload shapes
(``SHAPES``, ``LONG_OK``, ``Arch.shapes``)."""
import dataclasses

import pytest

import repro.configs as jconfigs
import repro_torch.configs as configs
from repro.models import RuntimeCfg as JaxRuntimeCfg
from repro_torch.configs import base
from repro_torch.models import RuntimeCfg
from torch_port_helpers import port_spec


def test_registry_lists_every_arch():
    assert configs.ARCHS == jconfigs.ARCHS and len(configs.ARCHS) == 10
    assert set(configs.PORTED) <= set(configs.ARCHS)
    assert base.LONG_OK == jconfigs.base.LONG_OK
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert [a.name for a in configs.all_archs()] == list(configs.ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-5")


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_arch_equals_reference(name):
    """SPEC and SMOKE field by field (nested MoE / MLA / SSM specs
    included), the same parameter counts and head dims, the skip reasons
    and shapes; RUNTIME is each package's default ``RuntimeCfg()``, equal
    on the fields both packages have."""
    mine, ref = configs.get(name), jconfigs.get(name)
    assert mine.name == ref.name == name
    for got, want in ((mine.spec, ref.spec), (mine.smoke, ref.smoke)):
        assert got == port_spec(want)
        assert got.params() == want.params()
        assert got.head_dim == want.head_dim
    assert mine.skip == ref.skip
    assert [s.name for s in mine.shapes()] == [s.name for s in ref.shapes()]
    assert mine.runtime == RuntimeCfg()
    assert ref.runtime == JaxRuntimeCfg()
    shared = {f.name for f in dataclasses.fields(RuntimeCfg)} \
        - {"attention_impl"}        # the port's "cuda" is its kernel
    assert {f: getattr(mine.runtime, f) for f in shared} \
        == {f: getattr(ref.runtime, f) for f in shared}
