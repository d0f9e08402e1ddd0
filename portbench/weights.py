"""The weights of a cell, made by the benchmark from the seed on the device
and laid out as the port's parameter tree, so that both the port and the
plain reference read the same tensors.

Every matrix is drawn by a few large ``torch.randn`` calls on a generator on
the device into one flat buffer of the served dtype (fp32 leaves into a
second one), and each leaf is a view of it scaled by 1/sqrt(its contraction
width); norm scales and Mamba's ``D`` are ones; ``A_log`` is the S4D-real
init log(1..d_state) shifted by log(1/64), so that the scan keeps a memory
of tens of steps.  The port's own ``init_params`` is not used.

A configuration brings the layer kinds the harness lacks in the module of
its ``model_type``, ``portbench/reference/<model_type>.py``, where there is
one.  The module may give ``layer_kind(cfg, l) -> (mixer, ffn)`` and
``KINDS``, a dict from each kind it adds to a dict of plain functions,
shaped as ``BUILTIN``, the harness's own kinds:

* ``key``: the key of the kind's subtree in a layer of the port's tree;
* ``leaves(cfg)``: ``{leaf: (shape, fan_in | rule)}``, as ``_attn_leaves``;
* ``reference(ref, p, x, grouping)``: the kind's output (to be added to
  the residual ``x``), computed with the ``Reference``'s ``mm``, ``a``,
  ``w``, ``w32`` and ``norm`` so that its float8 control follows;
* ``params_per_token(cfg)``: parameters in its matrix products a token;
* ``flops_per_position(cfg)``: FLOPs per attended position (left out by a
  kind that attends nothing)."""
from __future__ import annotations

import importlib
import math
from pathlib import Path

import torch

# elements drawn per randn call
DRAW_CHUNK = 1 << 30
# leaf offsets in the flat buffers are multiples of this many elements
ALIGN = 128
A_LOG_SHIFT = math.log(1.0 / 64.0)
REFERENCE = Path(__file__).resolve().parent / "reference"


def _attn_leaves(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    n, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["assumed"]["head_dim"]
    g = n // nkv
    return {"ln": ((H,), "one"), "w_q": ((H, nkv, g, dh), H),
            "w_k": ((H, nkv, dh), H), "w_v": ((H, nkv, dh), H),
            "w_o": ((nkv, g, dh, H), n * dh)}


def _ffn_leaves(H: int, width: int) -> dict:
    return {"ln": ((H,), "one"), "w_up": ((H, width), H),
            "w_down": ((width, H), width), "w_gate": ((H, width), H)}


def _moe_leaves(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    E, d = experts(cfg), expert_width(cfg)
    out = {"ln": ((H,), "one"), "w_router": ((H, E), H),
           "w_egate": ((E, H, d), H), "w_eup": ((E, H, d), H),
           "w_edown": ((E, d, H), d)}
    if cfg.get("n_shared_experts"):
        out["shared"] = _ffn_leaves(H, cfg["n_shared_experts"] * d)
    return out


def _mamba_leaves(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    din = cfg["mamba_expand"] * H
    r, P = cfg["mamba_dt_rank"], cfg["mamba_d_state"]
    return {"ln": ((H,), "one"), "w_in": ((H, 2 * din), H),
            "conv": ((cfg["mamba_d_conv"], din), 4.0),
            "w_xdb": ((din, r + 2 * P), din), "w_dt": ((r, din), r),
            "A_log": ((din, P), "a_log"), "D": ((din,), "one"),
            "w_out": ((din, H), din)}


def experts(cfg: dict) -> int:
    return cfg.get("n_routed_experts") or cfg.get("num_experts") or 0


def expert_width(cfg: dict) -> int:
    return cfg.get("moe_intermediate_size") or cfg["intermediate_size"]


def top_k(cfg: dict) -> int:
    return cfg["num_experts_per_tok"]


def _attn_params(cfg: dict) -> int:
    H = cfg["hidden_size"]
    n, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["assumed"]["head_dim"]
    return 2 * H * n * dh + 2 * H * nkv * dh


def _mamba_params(cfg: dict) -> int:
    H = cfg["hidden_size"]
    din = cfg["mamba_expand"] * H
    r, P = cfg["mamba_dt_rank"], cfg["mamba_d_state"]
    return H * 2 * din + din * (r + 2 * P) + r * din + din * H


def _moe_params(cfg: dict) -> int:
    """The router, the top-k routed and all shared experts (capacity
    padding and drops do not count)."""
    H, d = cfg["hidden_size"], expert_width(cfg)
    active = top_k(cfg) + cfg.get("n_shared_experts", 0)
    return H * experts(cfg) + active * 3 * H * d


# the harness's own layer kinds, shaped as a module's ``KINDS``
BUILTIN = {
    "attn": {"key": "attn", "leaves": _attn_leaves,
             "reference": lambda ref, p, x, grouping: ref.attention(p, x),
             "params_per_token": _attn_params,
             # QK^T and PV
             "flops_per_position": lambda cfg: 4 * cfg["num_attention_heads"]
             * cfg["assumed"]["head_dim"]},
    "mamba": {"key": "mamba", "leaves": _mamba_leaves,
              "reference": lambda ref, p, x, grouping: ref.mamba(p, x),
              "params_per_token": _mamba_params},
    "dense": {"key": "ffn",
              "leaves": lambda cfg: _ffn_leaves(cfg["hidden_size"],
                                                cfg["intermediate_size"]),
              "reference": lambda ref, p, x, grouping: ref.ffn(p, x),
              "params_per_token": lambda cfg: 3 * cfg["hidden_size"]
              * cfg["intermediate_size"]},
    "moe": {"key": "moe", "leaves": _moe_leaves,
            "reference": lambda ref, p, x, grouping: ref.moe(p, x, grouping),
            "params_per_token": _moe_params},
}


def kinds_module(cfg: dict):
    """``portbench/reference/<model_type>.py``, the module of layer kinds
    of the configuration's model type, or None where there is none."""
    name = cfg["model_type"]
    if not (name.isidentifier() and (REFERENCE / f"{name}.py").is_file()):
        return None
    return importlib.import_module(f"{__package__}.reference.{name}")


def kinds(cfg: dict) -> dict:
    """Every layer kind of the configuration: {kind: entry}, the harness's
    own and its module's, the module's first."""
    mod = kinds_module(cfg)
    return {**BUILTIN, **getattr(mod, "KINDS", {})}


def kind_problems(cfg: dict) -> list:
    """The layers of a kind that is defined nowhere ([] if none)."""
    table = kinds(cfg)
    return [f"layer {l}: kind {kind!r} is defined nowhere"
            for l in range(cfg["num_hidden_layers"])
            for kind in layer_kind(cfg, l) if kind not in table]


def layer_kind(cfg: dict, layer: int) -> tuple:
    """(mixer, ffn) of ``layer``: the configuration's module's, where it
    has a ``layer_kind``, else ``default_layer_kind``'s."""
    mod = kinds_module(cfg)
    if mod is not None and hasattr(mod, "layer_kind"):
        return mod.layer_kind(cfg, layer)
    return default_layer_kind(cfg, layer)


def default_layer_kind(cfg: dict, layer: int) -> tuple:
    """(mixer, ffn) of ``layer`` by the source's keys: mixer ``attn`` or
    ``mamba``, ffn ``dense`` or ``moe``."""
    if cfg["model_type"] == "jamba":
        mixer = "attn" if layer % cfg["attn_layer_period"] \
            == cfg["attn_layer_offset"] else "mamba"
        moe = experts(cfg) > 1 and layer % cfg["expert_layer_period"] \
            == cfg["expert_layer_offset"]
    else:
        mixer = "attn"
        moe = experts(cfg) > 0 and layer >= cfg["first_k_dense_replace"] \
            and layer % cfg["moe_layer_freq"] == 0
    return mixer, "moe" if moe else "dense"


def layer_leaves(cfg: dict, layer: int) -> dict:
    """The subtree of one layer: {leaf: (shape, fan_in | init rule)}."""
    table = kinds(cfg)
    return {table[k]["key"]: table[k]["leaves"](cfg)
            for k in layer_kind(cfg, layer)}


def layer_place(cfg: dict, layer: int) -> tuple:
    """Where layer ``layer`` lies in the port's tree: ("prefix", i, None) or
    ("slots", s, r), row r of slot s of the period."""
    pre, period = cfg["port"]["prefix_layers"], cfg["port"]["period"]
    if layer < pre:
        return "prefix", layer, None
    return "slots", (layer - pre) % period, (layer - pre) // period


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layout(cfg: dict) -> dict:
    """The tree of ``(shape, rule)`` leaves the port's ``lm`` expects:
    ``embed``, ``ln_f``, ``lm_head``, ``prefix`` (one subtree a layer) and
    ``slots`` (per slot of the period, leaves stacked over its repeats)."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    L = cfg["num_hidden_layers"]
    pre, period = cfg["port"]["prefix_layers"], cfg["port"]["period"]
    n_rep = (L - pre) // period
    tree = {"embed": ((V, H), 1.0), "ln_f": ((H,), "one"),
            "lm_head": ((H, V), H),
            "prefix": [layer_leaves(cfg, l) for l in range(pre)],
            "slots": []}
    for s in range(period):
        one = layer_leaves(cfg, pre + s)
        for r in range(1, n_rep):
            if _map(lambda x: 0, layer_leaves(cfg, pre + s + r * period)) \
                    != _map(lambda x: 0, one):
                raise ValueError(f"layer {pre + s + r * period} is not of "
                                 f"slot {s}'s kind")
        tree["slots"].append(_map(lambda leaf: ((n_rep,) + leaf[0], leaf[1]),
                                  one))
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The tree of ``layout(cfg)`` filled from ``seed`` on ``device``."""
    served = getattr(torch, cfg["served_dtype"])
    fp32 = set(cfg["fp32_leaves"])
    entries = list(_leaves(layout(cfg)))
    offsets = {served: 0, torch.float32: 0}
    placed = []
    for path, (shape, rule) in entries:
        dtype = torch.float32 if path[-1] in fp32 else served
        n = math.prod(shape)
        placed.append((path, shape, rule, dtype, offsets[dtype]))
        offsets[dtype] += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = {}
    for dtype, total in offsets.items():
        buf = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, DRAW_CHUNK):
            torch.randn(min(DRAW_CHUNK, total - lo), generator=gen,
                        dtype=dtype, device=device, out=buf[lo:lo + DRAW_CHUNK])
        flat[dtype] = buf
    tree = layout(cfg)
    for path, shape, rule, dtype, off in placed:
        leaf = flat[dtype][off:off + math.prod(shape)].view(shape)
        if rule == "one":
            leaf.fill_(1.0)
        elif rule == "a_log":
            P = shape[-1]
            a = torch.log(torch.arange(1, P + 1, dtype=torch.float32,
                                       device=device)) + A_LOG_SHIFT
            leaf.copy_(a.expand(shape))
        else:
            leaf.mul_(1.0 / math.sqrt(rule))
        _set(tree, path, leaf)
    return tree


def check_against_port(tree, port_axes) -> None:
    """Raise unless ``tree`` has the keys of the port's ``param_axes`` tree
    and each leaf as many dimensions as its axes."""
    mine = {p: t.dim() for p, t in _leaves(tree)}
    theirs = {}
    for p, axes in _leaves(port_axes):
        # param_axes' leaves are tuples of axis names: _leaves would walk
        # into them if they were lists
        theirs[p] = len(axes)
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()), key=str)[:8]
        raise ValueError(f"the benchmark's weight tree is not the port's: "
                         f"{diff}")
