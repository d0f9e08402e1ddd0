"""The port's copy of the HLO walker (``repro_torch.launch.hlo_analysis``)
against the JAX package's, on the HLO texts that
``tests/test_hlo_analysis.py``'s six programs compile to: the same dicts
(flops, bytes, collectives, collective bytes) and the same per-collective
totals.  The JAX side (compiling) lives here, not in the port."""
import jax
import jax.numpy as jnp
import pytest

from repro.launch import hlo_analysis as ref
from repro_torch.launch import hlo_analysis as port


def _scan(x, w):
    out, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=10)
    return out


def _nested(x, w):
    def outer(c, _):
        c, _ = jax.lax.scan(lambda c2, _: (jnp.tanh(c2 @ w), None), c, None,
                            length=5)
        return c, None
    out, _ = jax.lax.scan(outer, x, None, length=4)
    return out


def _unrolled(x, w):
    for _ in range(8):
        x = x @ w
    return x


def _chain(x):
    for _ in range(4):
        x = jnp.tanh(x) * 2 + 1
    return x


def _stacked(x):
    def body(c, _):
        c = c + 1.0
        return c, c
    _, ys = jax.lax.scan(body, x, None, length=64)
    return ys


def _square(a):
    return a @ a


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


PROGRAMS = {
    "scan": (_scan, (_sds(128, 128), _sds(128, 128))),
    "nested_scan": (_nested, (_sds(128, 128), _sds(128, 128))),
    "unrolled": (_unrolled, (_sds(64, 64), _sds(64, 64))),
    "elementwise_chain": (_chain, (_sds(1024, 1024),)),
    "scan_stacking": (_stacked, (_sds(256, 256),)),
    "single_device_product": (_square, (_sds(64, 64),)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_port_walker_equals_the_reference(name):
    fn, specs = PROGRAMS[name]
    hlo = jax.jit(fn).lower(*specs).compile().as_text()
    got, want = port.analyze_hlo(hlo), ref.analyze_hlo(hlo)
    assert got == want
    assert want["flops"] > 0
    assert port.collective_bytes(hlo) == ref.collective_bytes(hlo)


# a partitioned module as XLA prints it (two ranks): a while loop of six
# trips whose body all-gathers, all-reduces and multiplies
SHARDED_HLO = """HloModule sharded

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%cond (p: (s32[], f32[64,64])) -> pred[] {
  %p = (s32[], f32[64,64]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(6)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (p: (s32[], f32[64,64])) -> (s32[], f32[64,64]) {
  %p = (s32[], f32[64,64]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[64,64] get-tuple-element(%p), index=1
  %ag = f32[128,64] all-gather(%x), dimensions={0}, replica_groups={{0,1}}
  %d = f32[64,64] dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[64,64] all-reduce(%d), replica_groups={{0,1}}, to_apply=%add
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[64,64]) tuple(%i2, %ar)
}

ENTRY %main (a: f32[64,64]) -> f32[64,64] {
  %a = f32[64,64] parameter(0)
  %z = s32[] constant(0)
  %t0 = (s32[], f32[64,64]) tuple(%z, %a)
  %w = (s32[], f32[64,64]) while(%t0), condition=%cond, body=%body
  %r = f32[64,64] get-tuple-element(%w), index=1
  ROOT %rs = f32[32,64] reduce-scatter(%r), dimensions={0}, replica_groups={{0,1}}, to_apply=%add
}
"""


def test_port_walker_equals_the_reference_on_collectives():
    """Collectives by kind, under a loop's trip count, on a partitioned
    module's text."""
    got, want = (m.analyze_hlo(SHARDED_HLO) for m in (port, ref))
    assert got == want
    assert want["collectives"] == {"all-gather": 6 * 64 * 64 * 4,
                                   "all-reduce": 6 * 64 * 64 * 4,
                                   "reduce-scatter": 64 * 64 * 4}
    assert want["flops"] >= 6 * 2 * 64 ** 3
