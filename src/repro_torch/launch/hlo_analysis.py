"""Trip-count-aware HLO cost analysis, own copy of
``repro.launch.hlo_analysis`` (pure Python: ``re`` and the standard
library).

``compiled.cost_analysis()`` visits every instruction once, so anything
under a ``while`` (lax.scan over layer groups / kv chunks / grad accum)
is undercounted by its trip count, and it reports no collective volume
at all.  This walker parses the SPMD-partitioned HLO text and computes,
with loop multipliers applied:

* ``flops``   — 2·M·N·K for dots (+1/elem for elementwise/reduce ops),
* ``bytes``   — HBM traffic at fusion boundaries (fusion internals are
  register/VMEM-resident, so only fusion operands+results count),
* ``collectives`` — per-kind operand bytes of all-gather / all-reduce /
  reduce-scatter / all-to-all / collective-permute.

Shapes in the partitioned module are per-device, so every quantity is
per-device.

No caller in the port feeds it HLO: PyTorch runs the program eagerly and
compiles no partitioned module.  The port's dry run (``launch.dryrun``)
counts the eager program instead, op by op on rank 0's local shards.  This
walker stays for HLO text that comes from elsewhere (the JAX package's dry
run), so that the two packages read it alike.
"""
from __future__ import annotations

import functools
import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16, "token": 0,
}

_SHAPE_RE = re.compile(r"\b([a-z]\d?[a-z0-9]*)\[([\d,]*)\]")
_RESULT_SPLIT = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_TUPLE_OR_SHAPE = re.compile(
    r"^(\((?:[^()]|\([^()]*\))*\)|[a-z]\d?[a-z0-9]*\[[\d,]*\](?:\{[^}]*\})?)\s*")
_OPCODE_RE = re.compile(r"^([\w\-]+)\(")
_COMP_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_CDIM_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_TRIP_RE = re.compile(r"constant\((\d+)\)")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")

ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "exponential", "log", "tanh", "rsqrt", "sqrt", "power",
    "logistic", "select", "compare", "and", "or", "not", "xor", "convert",
    "floor", "ceil", "sign", "clamp", "cosine", "sine",
    "exponential-minus-one",
}
COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute"}
SKIP_BYTES = {"get-tuple-element", "tuple", "parameter", "constant", "bitcast",
              "after-all", "partition-id", "replica-id", "iota", "while",
              "conditional", "call", "copy", "reshape", "broadcast"}


def _parse_dims(dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n


def _shapes_bytes(shapes) -> float:
    return float(sum(_parse_dims(d) * _DTYPE_BYTES.get(t, 4)
                     for t, d in shapes))


@dataclass
class CompCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = field(default_factory=lambda: defaultdict(float))
    calls: list = field(default_factory=list)     # (callee, mult, fused)


class HloCost:
    def __init__(self, hlo: str):
        self.comps: dict[str, list[str]] = {}
        cur = None
        for line in hlo.splitlines():
            stripped = line.rstrip()
            if stripped.endswith("{") and "=" not in line.split("(")[0]:
                m = _COMP_RE.match(line)
                if m and "->" in line:
                    cur = m.group(1)
                    self.comps[cur] = []
                    continue
            if cur is not None:
                if stripped.strip() == "}":
                    cur = None
                else:
                    self.comps[cur].append(line)

        # symbol table: instruction name -> result shapes  (module-global;
        # HLO instruction names are unique within the module text we see)
        self.shape_of: dict[str, list] = {}
        for lines in self.comps.values():
            for line in lines:
                m = _RESULT_SPLIT.match(line)
                if not m:
                    continue
                name, rhs = m.groups()
                tm = _TUPLE_OR_SHAPE.match(rhs)
                if tm:
                    self.shape_of[name] = _SHAPE_RE.findall(tm.group(1))
        # computation parameters
        self._param_shapes()

        self.costs = {name: self._analyze(name) for name in self.comps}
        roots = [n for n in self.comps if n.startswith("main") or ".main" in n
                 or n == "entry"]
        self.root = roots[0] if roots else (
            max(self.comps, key=lambda n: len(self.comps[n]))
            if self.comps else None)

    def _param_shapes(self):
        # header lines were consumed; parameters appear as instructions
        # "%p = f32[...] parameter(0)" inside bodies — handled by the
        # symbol table above.
        pass

    def _operands(self, line: str, opcode: str) -> list:
        start = line.index(opcode + "(") + len(opcode) + 1
        depth = 1
        i = start
        while i < len(line) and depth:
            if line[i] == "(":
                depth += 1
            elif line[i] == ")":
                depth -= 1
            i += 1
        seg = line[start:i - 1]
        shapes = []
        for nm in _OPERAND_RE.findall(seg):
            shapes.extend(self.shape_of.get(nm, []))
        if not shapes:
            shapes = _SHAPE_RE.findall(seg)
        return shapes

    # -- per-computation ----------------------------------------------------
    def _analyze(self, name: str) -> CompCost:
        cc = CompCost()
        for line in self.comps[name]:
            m = _RESULT_SPLIT.match(line)
            if not m:
                continue
            iname, rhs = m.groups()
            tm = _TUPLE_OR_SHAPE.match(rhs)
            if not tm:
                continue
            rest = rhs[tm.end():]
            om = _OPCODE_RE.match(rest)
            if not om:
                continue
            opcode = om.group(1)
            res_shapes = _SHAPE_RE.findall(tm.group(1))

            if opcode == "dot":
                ops = self._operands(line, opcode)
                contract = 1
                cm = _CDIM_RE.search(line)
                if cm and ops:
                    lhs_dims = [int(x) for x in ops[0][1].split(",") if x]
                    for ci in (int(x) for x in cm.group(1).split(",") if x):
                        if ci < len(lhs_dims):
                            contract *= lhs_dims[ci]
                cc.flops += 2.0 * _parse_dims(res_shapes[0][1]) * contract \
                    if res_shapes else 0.0
                cc.bytes += _shapes_bytes(res_shapes) + _shapes_bytes(ops)
            elif opcode in ELEMENTWISE and res_shapes:
                cc.flops += float(_parse_dims(res_shapes[0][1]))
            elif opcode in ("reduce", "reduce-window"):
                ops = self._operands(line, opcode)
                if ops:
                    cc.flops += float(_parse_dims(ops[0][1]))
            else:
                base = opcode.replace("-start", "").replace("-done", "")
                if base in COLLECTIVES and not opcode.endswith("-done"):
                    ops = self._operands(line, opcode)
                    vol = _shapes_bytes(ops) or _shapes_bytes(res_shapes)
                    cc.coll[base] += vol
                    cc.bytes += vol + _shapes_bytes(res_shapes)

            if opcode == "while":
                cm_ = re.search(r"condition=%?([\w.\-]+)", line)
                bm_ = re.search(r"body=%?([\w.\-]+)", line)
                if cm_ and bm_:
                    cc.calls.append((bm_.group(1),
                                     self._trip(cm_.group(1)), False))
            elif opcode == "fusion":
                fm = re.search(r"calls=%?([\w.\-]+)", line)
                if fm:
                    cc.calls.append((fm.group(1), 1, True))
                ops = self._operands(line, opcode)
                if "dynamic-update-slice" in iname or \
                        "dynamic_update_slice" in line:
                    # in-place DUS fusion: the aliased full buffer does not
                    # stream through HBM — only the update slice does
                    sizes = sorted((_shapes_bytes([s]) for s in ops),
                                   reverse=True)
                    cc.bytes += 2 * sum(sizes[1:])
                elif "dynamic-slice" in iname or "dynamic_slice" in line:
                    # gather-style fusion (e.g. per-iteration slice of the
                    # stacked layer params): traffic = the slice, not the
                    # whole loop-invariant buffer
                    sizes = sorted((_shapes_bytes([s]) for s in ops),
                                   reverse=True)
                    cc.bytes += _shapes_bytes(res_shapes) + sum(sizes[1:]) \
                        + min(sizes[0] if sizes else 0.0,
                              _shapes_bytes(res_shapes))
                else:
                    res_b = _shapes_bytes(res_shapes)
                    # cap any single operand at 8x the result: fusions that
                    # merely slice/select from a loop-invariant giant buffer
                    # (stacked params under scan) do not stream it fully
                    cc.bytes += res_b + sum(
                        min(_shapes_bytes([s]), max(8 * res_b, 1 << 20))
                        for s in ops)
            elif opcode in ("call", "conditional", "custom-call",
                            "async-start"):
                for fm in re.finditer(
                        r"(?:to_apply=|branch_computations=\{|"
                        r"called_computations=\{|calls=)%?([\w.\-]+)", line):
                    if fm.group(1) in self.comps:
                        cc.calls.append((fm.group(1), 1, False))
                if opcode == "custom-call":
                    ops = self._operands(line, opcode)
                    cc.bytes += _shapes_bytes(res_shapes) + _shapes_bytes(ops)
            elif opcode == "sort" and res_shapes:
                import math as _math
                n = _parse_dims(res_shapes[0][1])
                cc.flops += n * max(1.0, _math.log2(max(2, n)))
                cc.bytes += _shapes_bytes(res_shapes) * 2
            elif opcode == "dynamic-update-slice":
                # in-place update: traffic = the update slice (read+write),
                # not the full aliased buffer
                ops = self._operands(line, opcode)
                upd = ops[1:2] if len(ops) > 1 else res_shapes
                cc.bytes += 2 * _shapes_bytes(upd)
            elif opcode in ("dynamic-slice", "slice", "pad", "transpose",
                            "gather", "reverse"):
                cc.bytes += 2 * _shapes_bytes(res_shapes)
            elif opcode in ("scatter", "select-and-scatter"):
                ops = self._operands(line, opcode)
                upd = ops[2:3] if len(ops) > 2 else res_shapes
                cc.bytes += 2 * _shapes_bytes(upd) + _shapes_bytes(res_shapes)
            elif opcode == "concatenate":
                ops = self._operands(line, opcode)
                cc.bytes += _shapes_bytes(res_shapes) + _shapes_bytes(ops)
        return cc

    def _trip(self, cond_name: str) -> int:
        for line in self.comps.get(cond_name, []):
            m = _TRIP_RE.search(line)
            if m:
                return int(m.group(1))
        # constant may live behind a fusion call in the condition
        for line in self.comps.get(cond_name, []):
            fm = re.search(r"calls=%?([\w.\-]+)", line)
            if fm:
                for l2 in self.comps.get(fm.group(1), []):
                    m = _TRIP_RE.search(l2)
                    if m:
                        return int(m.group(1))
        return 1

    # -- totals ---------------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def _total(self, name: str, inside_fusion: bool) -> tuple:
        cc = self.costs.get(name)
        if cc is None:
            return (0.0, 0.0, ())
        flops = cc.flops
        byts = 0.0 if inside_fusion else cc.bytes
        coll = defaultdict(float, cc.coll)
        for callee, mult, fused in cc.calls:
            f2, b2, c2 = self._total(callee, inside_fusion or fused)
            flops += f2 * mult
            byts += b2 * mult
            for k, v in c2:
                coll[k] += v * mult
        return (flops, byts, tuple(sorted(coll.items())))

    def totals(self) -> dict:
        if self.root is None:
            return {"flops": 0.0, "bytes": 0.0, "collectives": {},
                    "collective_bytes": 0.0}
        f, b, c = self._total(self.root, False)
        return {"flops": f, "bytes": b, "collectives": dict(c),
                "collective_bytes": float(sum(v for _, v in c))}


def collective_bytes(hlo: str) -> dict[str, float]:
    return HloCost(hlo).totals()["collectives"]


def analyze_hlo(hlo: str) -> dict:
    return HloCost(hlo).totals()
