"""Graph lint: structural checks over assembled/distributed symbolic graphs.

All checks are pure traversal over op/tensor identity (uids) — shape
*expressions* are compared structurally first and only simplified on a
candidate mismatch, so linting a clean graph never pays a sympy
``simplify``.
"""
from __future__ import annotations

from typing import Optional

import sympy as sp

from ..core.stg import Einsum, Graph, SendRecv
from ..core.symbolic import Env
from .diagnostics import (DANGLING_TENSOR, EINSUM_DIM_MISMATCH,
                          GRAPH_CYCLE, GUARD_CONTRADICTION, Report,
                          UNBOUND_SYMBOL, UNPAIRED_SENDRECV,
                          UNREACHABLE_NODE)


def lint_graph(graph: Graph, env: Optional[Env] = None, *,
               name: str = "graph") -> Report:
    """Run every graph-lint rule; see the ``STG0xx`` registry."""
    rep = Report(name=name)
    _check_dangling(graph, rep)
    _check_cycles(graph, rep)
    _check_unreachable(graph, rep)
    _check_einsum_dims(graph, rep)
    _check_sendrecv_stages(graph, rep)
    if env is not None:
        _check_unbound(graph, env, rep)
    rep.tally("graph_lint", len(graph.ops))
    return rep


def check_guards(guards: dict, cfg, *, name: str = "guards") -> Report:
    """Divisibility-guard contradiction check (``STG006``).

    ``guards`` is the ``{(value, axes): outcome}`` log collected by
    :func:`repro_torch.core.distribute.record_guards`; the recorded outcome
    must equal what ``cfg``'s axis degrees imply, otherwise the
    structure class the guards describe does not match the config it is
    being replayed for (the compiled backend's cache contract)."""
    rep = Report(name=name)
    for (val, axes), ok in guards.items():
        deg = 1
        for a in axes:
            deg *= cfg.axes.get(a, 1)
        actual = val % deg == 0
        if actual != ok:
            rep.add(GUARD_CONTRADICTION,
                    f"guard ({val} %% {'*'.join(axes)}={deg} == 0) was "
                    f"recorded as {ok} but evaluates to {actual} for this "
                    f"config",
                    node=(val, axes),
                    fixit="re-lower the structure class for this config "
                          "instead of replaying a cached program")
    rep.tally("guards", len(guards))
    return rep


# --------------------------------------------------------------------------
# individual rules
# --------------------------------------------------------------------------

def _check_dangling(graph: Graph, rep: Report) -> None:
    produced = {t.uid for t in graph.inputs + graph.weights}
    for op in graph.ops:
        for t in op.outs:
            produced.add(t.uid)
    for op in graph.ops:
        for t in op.ins:
            if t.uid not in produced:
                rep.add(DANGLING_TENSOR,
                        f"op {op.name!r} ({op.kind}) consumes tensor "
                        f"{t.name!r} (uid {t.uid}) that no op, input or "
                        f"weight produces",
                        node=op.uid, phase=op.phase,
                        fixit="register the tensor as a graph input or add "
                              "its producer before this op")


def _check_cycles(graph: Graph, rep: Report) -> None:
    """Iterative DFS over op->op edges (producer -> consumer)."""
    producer: dict[int, int] = {}           # tensor uid -> op index
    for i, op in enumerate(graph.ops):
        for t in op.outs:
            producer[t.uid] = i
    succs: dict[int, list[int]] = {i: [] for i in range(len(graph.ops))}
    for i, op in enumerate(graph.ops):
        for t in op.ins:
            j = producer.get(t.uid)
            if j is not None and j != i:
                succs[j].append(i)
    WHITE, GREY, BLACK = 0, 1, 2
    color = [WHITE] * len(graph.ops)
    for root in range(len(graph.ops)):
        if color[root] != WHITE:
            continue
        stack = [(root, iter(succs[root]))]
        color[root] = GREY
        while stack:
            i, it = stack[-1]
            advanced = False
            for j in it:
                if color[j] == GREY:
                    cyc = [graph.ops[k].name for k, _ in stack[-4:]]
                    rep.add(GRAPH_CYCLE,
                            f"op {graph.ops[j].name!r} participates in a "
                            f"dependency cycle (via {' -> '.join(cyc)})",
                            node=graph.ops[j].uid)
                    continue
                if color[j] == WHITE:
                    color[j] = GREY
                    stack.append((j, iter(succs[j])))
                    advanced = True
                    break
            if not advanced:
                color[i] = BLACK
                stack.pop()


def _check_unreachable(graph: Graph, rep: Report) -> None:
    """Dead ops: nothing consumes any output and no output is a graph
    output/grad.  Optimizer ops are terminal by design (their outputs
    ARE the updated state), and ops tagged as sinks (e.g. decode-time
    KV-cache appends, whose output is a state write) are exempt."""
    consumed: set[int] = set()
    for op in graph.ops:
        for t in op.ins:
            consumed.add(t.uid)
    live = consumed | {t.uid for t in graph.outputs} \
        | {g.uid for g in graph.grads.values()}
    for op in graph.ops:
        if op.phase == "opt" or op.tags.get("sink"):
            continue
        if any(t.uid in live for t in op.outs):
            continue
        if all(t.kind == "index" for t in op.outs):
            continue
        rep.add(UNREACHABLE_NODE,
                f"op {op.name!r} ({op.kind}, phase {op.phase}) produces "
                f"only unconsumed tensors — dead code in the graph",
                node=op.uid, phase=op.phase,
                fixit="remove the op or register an output as a graph "
                      "output")


def _check_einsum_dims(graph: Graph, rep: Report) -> None:
    for op in graph.ops:
        if not isinstance(op, Einsum):
            continue
        dims: dict[str, object] = {}
        where: dict[str, str] = {}
        operands = list(zip(op.in_specs, (t.shape for t in op.ins)))
        operands.append((op.out_spec, op.out.shape))
        for letters, shape in operands:
            if len(letters) != len(shape):
                rep.add(EINSUM_DIM_MISMATCH,
                        f"einsum {op.name!r}: spec {letters!r} has "
                        f"{len(letters)} letters but operand is rank "
                        f"{len(shape)}",
                        node=op.uid, phase=op.phase)
                continue
            for ch, d in zip(letters, shape):
                prev = dims.get(ch)
                if prev is None:
                    dims[ch] = d
                    where[ch] = letters
                elif prev != d and sp.simplify(prev - d) != 0:
                    rep.add(EINSUM_DIM_MISMATCH,
                            f"einsum {op.name!r} ({op.spec}): letter "
                            f"{ch!r} binds {prev} (from {where[ch]!r}) "
                            f"but also {d} (from {letters!r})",
                            node=op.uid, phase=op.phase,
                            fixit="reshape the operand or fix the spec so "
                                  "every occurrence of a letter shares one "
                                  "dim expression")


def _check_sendrecv_stages(graph: Graph, rep: Report) -> None:
    for op in graph.ops:
        if isinstance(op, SendRecv) and op.src_stage == op.dst_stage:
            rep.add(UNPAIRED_SENDRECV,
                    f"SendRecv {op.name!r} sends stage "
                    f"{op.src_stage} to itself — self-send deadlocks a "
                    f"blocking transport",
                    node=op.uid, stage=op.src_stage, phase=op.phase)


def _check_unbound(graph: Graph, env: Env, rep: Report) -> None:
    bound = set(env.keys())
    reported: set[str] = set()
    for t in graph.tensors():
        for d in t.shape:
            if isinstance(d, sp.Basic):
                for s in d.free_symbols:
                    if s not in bound and s.name not in reported:
                        reported.add(s.name)
                        rep.add(UNBOUND_SYMBOL,
                                f"shape symbol {s.name!r} (first seen on "
                                f"tensor {t.name!r}) is not bound by the "
                                f"env",
                                node=t.name,
                                fixit=f"bind {s.name!r} in the env (see "
                                      f"repro_torch.core.assemble.bind_env)")
