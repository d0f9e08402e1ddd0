"""Symbolic dimension algebra for the Symbolic Tensor Graph (STG) IR.

Dimensions are sympy expressions over *model symbols* (B, S, H, ...).
Partition factors (dp, tp, ...) are NOT baked into the dim expression;
they live in the tensor's :class:`~repro_torch.core.tensor.ShardSpec` so the
collective matcher can reason about producer/consumer layouts directly
(the paper renders ``x[B/dp, H]`` — we store shape ``[B, H]`` + the
partition annotation ``{0: (dp,)}``; the printed form is identical).

Everything here is pure Python/sympy — no JAX — so STG construction and
instantiation run anywhere (the paper's laptop-scale claim, Fig 13).
"""
from __future__ import annotations

import functools
from typing import Mapping, Union

import sympy as sp

Expr = Union[sp.Expr, int]


@functools.lru_cache(maxsize=None)
def sym(name: str) -> sp.Symbol:
    """A positive-integer model symbol (cached so ``sym('B') is sym('B')``)."""
    return sp.Symbol(name, positive=True, integer=True)


# Canonical symbols used by the built-in module templates.  Users may mint
# arbitrary additional symbols through :func:`sym`.
B = sym("B")            # global batch (sequences)
S = sym("S")            # sequence length
H = sym("H")            # model/embedding dim  (d_model)
Dff = sym("Dff")        # feed-forward hidden dim
NH = sym("NH")          # query heads
NKV = sym("NKV")        # kv heads (GQA)
DH = sym("DH")          # head dim
V = sym("V")            # vocab size
L = sym("L")            # layer count
E = sym("E")            # routed experts
K = sym("K")            # top-k routed experts per token
SH = sym("SH")          # shared experts
R = sym("R")            # low-rank dim (MLA kv_lora / rwkv decay rank)
P = sym("P")            # state dim (SSM)
Skv = sym("Skv")        # kv-cache length at decode time
Senc = sym("Senc")      # encoder context length (enc-dec / VLM)


class Env(dict):
    """Binding of model symbols -> concrete values, with expression evaluation.

    Values are exact: Python ints, or ``sympy.Rational`` for the few
    genuinely fractional bindings (MoE expert capacity at decode is the
    *expected* routed-token count ``B*S*K/E``, which need not be
    integral).  Exactness matters — the compiled backend converts bound
    coefficient values to floats at fixed points, and bit-identical
    backend parity relies on both paths starting from the same exact
    value."""

    def __init__(self, bindings: Mapping[Union[str, sp.Symbol], int] | None = None, **kw):
        super().__init__()
        merged: dict = dict(bindings or {})
        merged.update(kw)
        for k, v in merged.items():
            if not isinstance(v, int):
                r = sp.Rational(v)
                v = int(r) if r.is_Integer else r
            self[sym(k) if isinstance(k, str) else k] = v
        self._cache: dict = {}

    def evaluate(self, expr: Expr) -> int:
        """Evaluate ``expr`` to a concrete int (must be fully bound & integral).

        Cached per expression — instantiation evaluates the same handful of
        shape products thousands of times across layers (Fig 13 scalability).
        """
        if isinstance(expr, int):
            return expr
        if isinstance(expr, sp.Integer):
            return int(expr)
        hit = self._cache.get(expr)
        if hit is not None:
            return hit
        val = expr.subs(self)
        if not val.is_number:
            raise ValueError(f"unbound symbols {val.free_symbols} in {expr!r}")
        f = float(val)
        i = int(round(f))
        if abs(f - i) > 1e-6 * max(1.0, abs(f)):
            raise ValueError(f"{expr!r} evaluates to non-integer {f} under {dict(self)}")
        self._cache[expr] = i
        return i

    def fevaluate(self, expr: Expr) -> float:
        """Float-tolerant evaluation (sizes/volumes may be fractional in
        expectation, e.g. MoE capacity = B*S*K/E at decode)."""
        if isinstance(expr, (int, float)):
            return float(expr)
        key = ("f", expr)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        val = sp.sympify(expr).subs(self)
        if not val.is_number:
            raise ValueError(f"unbound symbols {val.free_symbols} in {expr!r}")
        f = float(val)
        self._cache[key] = f
        return f

    def evaluate_shape(self, shape: tuple[Expr, ...]) -> tuple[int, ...]:
        return tuple(self.evaluate(d) for d in shape)

    def signature(self) -> tuple:
        """Hashable identity of the bindings (cache key for compiled
        cost programs — one numeric program per distinct binding)."""
        return tuple(sorted((s.name, v) for s, v in self.items()))


def prod(exprs) -> sp.Expr:
    out: sp.Expr = sp.Integer(1)
    for e in exprs:
        out = out * e
    return out


def fmt_expr(expr: Expr) -> str:
    return str(expr)
