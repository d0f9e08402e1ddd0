"""Generic decoder LM of the port, covering all ten architectures: dense
GQA decoders (plain, MQA, alternating local/global windows), MLA and MoE
(deepseek), RWKV6, the Mamba + attention + MoE hybrid (jamba), an encoder
with decoder cross-attention (whisper) and a vision prefix (internvl2).

The layer stack is an unstacked *prefix* (deepseek's first dense layer)
followed by a repeating *period* (1 for a plain decoder, 2 for alternating
local/global windows, 8 for jamba's seven Mamba layers and one attention
layer); the parameters of each slot of the period are stacked ``[n_rep,
...]`` exactly as in the JAX package, as are the encoder's layers and the
decoder's cross-attention (one per layer), so a parameter tree carries
across leaf by leaf.  Where the JAX package scans over a stack, the port
loops over views of it.

API:
  init_params(spec, rt, generator, device=)    -> parameter tree
  param_axes(spec)                             -> its logical axes
  forward(params, tokens, spec, rt, frames=, vision=) -> logits (train /
                                                 prefill; differentiable)
  loss_fn(params, batch, spec, rt)             -> scalar (mean token CE)
  init_cache(spec, rt, batch, kv_len, device=) -> decode cache
  decode_step(params, cache, tokens, spec, rt) -> (logits, cache)

``forward`` records autograd wherever a parameter requires grad; a caller
that only serves runs it under ``torch.no_grad()``.  Training needs a
runtime whose attention is not the forward-only kernel
(``attention_impl="chunked"``): the kernels refuse an input that requires
grad.  ``rt.remat`` checkpoints the prefix layers, each repeat of the
period and each encoder layer, as the JAX package does.

A block kind no configuration has raises ``NotImplementedError``.

With ``repro_torch.obs`` tracing on, each layer boundary records a span, in
prefill and in decode: ``model.embed``, the mixer (``model.attn`` /
``model.mla`` / ``model.mamba`` / ``model.rwkv``), ``model.cross``, the FFN
(``model.moe`` / ``model.ffn``) and ``model.logits``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from .._device import resolve_device
from ..obs.spans import span, traced
from .common import (AxesInitializer, AxisRules, Initializer, RuntimeCfg,
                     _tree_map, dt, embed_rows, local_shape_and_offset,
                     mesh_of, on_mesh, replicated)

# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------


BLOCKS = ("gqa", "mla", "mamba", "rwkv6")


def _require_ported(spec) -> None:
    """Raise for a block kind that neither package builds."""
    if spec.block not in BLOCKS:
        raise NotImplementedError(
            f"{spec.name!r}: block kind {spec.block!r} is none of {BLOCKS}")


def _slot_kind(spec, layer: int) -> dict:
    """Describe layer ``layer``: mixer kind, window, ffn kind."""
    mixer = "attn"
    if spec.block == "rwkv6":
        mixer = "rwkv"
    elif spec.block == "mamba" and spec.attn_every <= 1:
        mixer = "mamba"
    elif spec.attn_every > 1:
        mixer = "attn" if layer % spec.attn_every == spec.attn_offset \
            else "mamba"
    window = spec.window if spec._is_local_layer(layer) else None
    if mixer != "attn":
        window = None
    if spec._is_moe_layer(layer):
        ffn = "moe"
    elif mixer == "rwkv":
        ffn = None                       # channel-mix lives inside the block
    elif spec.block == "mamba" and spec.attn_every <= 1:
        ffn = None                       # pure-mamba: no separate FFN
    else:
        ffn = "ffn"
    return {"mixer": mixer, "window": window, "ffn": ffn}


def layer_pattern(spec) -> tuple:
    """(n_prefix_unstacked, period).  Pattern repeats every ``period``
    layers after the prefix (deepseek's first dense layer); a stack whose
    pattern does not repeat (an odd number of alternating layers) is all
    prefix, unstacked."""
    prefix = 1 if (spec.moe and spec.moe.first_dense) else 0
    n = spec.n_layers - prefix
    period = 1
    if spec.attn_every > 1:
        period = math.lcm(period, spec.attn_every)
    if spec.moe and spec.moe.every > 1:
        period = math.lcm(period, spec.moe.every)
    if spec.window_pattern == "alternate":
        period = math.lcm(period, 2)
    if n % period != 0:
        period = 1 if n == 0 else math.gcd(period, n)
    # verify the pattern truly repeats
    for l in range(prefix, spec.n_layers):
        base = prefix + (l - prefix) % period
        if _slot_kind(spec, l) != _slot_kind(spec, base):
            return (spec.n_layers, 1)    # fully unstacked fallback
    return (prefix, period)


def _n_rep(spec) -> int:
    prefix_n, period = layer_pattern(spec)
    return (spec.n_layers - prefix_n) // period if period else 0


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


# an encoder layer of whisper: unmasked self-attention and a dense FFN
ENC_KIND = {"mixer": "attn", "window": None, "ffn": "ffn"}


def _init_slot(ini: Initializer, spec, kind: dict, prefix: str) -> dict:
    p: dict = {}
    if kind["mixer"] == "rwkv":
        p["rwkv"] = L.init_rwkv6(ini, spec, prefix + "r_")
    elif kind["mixer"] == "mamba":
        p["mamba"] = L.init_mamba(ini, spec, prefix + "m_")
    elif spec.block == "mla":
        p["attn"] = L.init_mla(ini, spec, prefix + "a_")
    else:
        p["attn"] = L.init_gqa(ini, spec, prefix + "a_")
    if kind["ffn"] == "moe":
        p["moe"] = L.init_moe(ini, spec, prefix + "f_")
    elif kind["ffn"] == "ffn":
        p["ffn"] = L.init_ffn(ini, spec, prefix=prefix + "f_")
    return p


def _build(ini, spec) -> dict:
    """The parameter tree, each leaf what ``ini`` gives for it: a tensor
    (``Initializer``) or its logical axes (``AxesInitializer``)."""
    H, V = spec.d_model, spec.vocab
    params: dict = {
        "embed": ini("embed", (V, H), (L.VOCAB, L.EMB), scale=1.0),
        "ln_f": ini("ln_f", (H,), (L.EMB,)),
        "lm_head": ini("lm_head", (H, V), (L.EMB, L.VOCAB)),
    }
    if spec.encoder_layers:
        params["encoder"] = ini.stack(
            lambda i: _init_slot(ini, spec, ENC_KIND, f"enc{i}_"),
            spec.encoder_layers)
        params["ln_enc"] = ini("ln_enc", (H,), (L.EMB,))
        # decoder cross-attention, one per decoder layer
        params["cross"] = ini.stack(
            lambda i: L.init_gqa(ini, spec, f"x{i}_"), spec.n_layers)
    prefix_n, period = layer_pattern(spec)
    params["prefix"] = [_init_slot(ini, spec, _slot_kind(spec, l), f"pl{l}_")
                        for l in range(prefix_n)]
    n_rep = _n_rep(spec)
    params["slots"] = [
        ini.stack(lambda r, kind=_slot_kind(spec, prefix_n + s), s=s:
                  _init_slot(ini, spec, kind, f"l{r}s{s}_"), n_rep)
        for s in range(period)]
    return params


def init_params(spec, rt: RuntimeCfg, generator: Optional[torch.Generator] = None,
                *, device=None, seed: int = 0) -> dict:
    """Random parameters on ``device`` (the card unless ``device="cpu"``),
    drawn from ``generator`` (made from ``seed`` on that device if None)."""
    _require_ported(spec)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    return _build(Initializer(generator, rt.param_dtype, device), spec)


def param_axes(spec, rt: Optional[RuntimeCfg] = None) -> dict:
    """The logical axes of every leaf of ``init_params(spec, rt)``: a tree
    of the same structure with tuples of axis names as leaves, ``"layers"``
    first on stacked leaves; equal to the JAX package's
    ``paxes(init_params(...))``.  Builds no tensor; the axes do not depend
    on ``rt``."""
    _require_ported(spec)
    return _build(AxesInitializer(), spec)


def _index(tree, i: int):
    """Layer ``i`` of a stacked subtree, as views."""
    return _tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


# the span of each mixer kind (``_slot_kind``'s, attention split into GQA and
# MLA) and FFN kind
_MIXER_SPANS = {"rwkv": "model.rwkv", "mamba": "model.mamba",
                "attn": "model.attn", "mla": "model.mla"}
_FFN_SPANS = {"moe": "model.moe", "ffn": "model.ffn"}


def _apply_slot(p: dict, x, spec, rt, rules, kind: dict, *, positions=None,
                cache=None, cross_kv=None, cross_p=None, cross_cache=None):
    name = kind["mixer"]
    layer_cache = None if cache is None else cache.get(name)
    with span(_MIXER_SPANS["mla" if name == "attn" and spec.block == "mla"
                           else name]):
        if name == "rwkv":
            x, c = L.rwkv6_layer(p["rwkv"], x, spec, rt, rules,
                                 cache=layer_cache)
        elif name == "mamba":
            x, c = L.mamba_layer(p["mamba"], x, spec, rt, rules,
                                 cache=layer_cache)
        elif spec.block == "mla":
            x, c = L.mla_attention(p["attn"], x, spec, rt, rules,
                                   positions=positions, cache=layer_cache)
        else:
            x, c = L.gqa_attention(p["attn"], x, spec, rt, rules,
                                   positions=positions, window=kind["window"],
                                   cache=layer_cache)
    new_cache = {name: c} if c is not None else {}
    if cross_p is not None:
        with span("model.cross"):
            x, cc = L.gqa_attention(cross_p, x, spec, rt, rules,
                                    cross_kv=cross_kv, cache=cross_cache)
        if cache is not None:
            new_cache["cross"] = cc
    if kind["ffn"] is not None:
        with span(_FFN_SPANS[kind["ffn"]]):
            if kind["ffn"] == "moe":
                x = L.moe_ffn(p["moe"], x, spec, rt, rules)
            else:
                x = L.ffn(p["ffn"], x, spec, rt, rules)
    return x, new_cache or None


def _save_unbatched_products(ctx, func, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matrix products without batch dimensions (JAX's
    ``dots_with_no_batch_dims_saveable``), recompute everything else.  A
    weight product ``x @ W`` runs as ``mm``; an einsum without batch dims
    runs as a ``bmm`` of batch 1, which is kept too."""
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.addmm.default) or (
            func is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, rt: RuntimeCfg):
    """``fn`` under activation checkpointing as ``rt.remat`` asks: ``"full"``
    keeps only its inputs, ``"dots"`` also the un-batched products."""
    if rt.remat == "none":
        return fn
    if rt.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if rt.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_unbatched_products))
    raise ValueError(f"remat {rt.remat!r}: one of none | full | dots")


def _run_encoder(params: dict, frames, spec, rt: RuntimeCfg, rules=None):
    """The encoder over frame embeddings [B, T, H]: unmasked self-attention
    and a dense FFN per layer, then ``ln_enc``."""
    def enc_block(x, p):
        x, _ = L.gqa_attention(p["attn"], x, spec, rt, rules, causal=False)
        return L.ffn(p["ffn"], x, spec, rt, rules)

    x = L.cast(frames, rt)
    for i in range(spec.encoder_layers):
        x = _remat(enc_block, rt)(x, _index(params["encoder"], i))
    return L.rms_norm(params["ln_enc"], x)


@traced("model.logits")
def _logits(params: dict, x, spec, rt: RuntimeCfg, rules=None):
    x = L.rms_norm(params["ln_f"], x)
    x = L.constrain(x, rules, (L.BATCH, L.SEQ, L.EMB))
    logits = L.matmul(x, L.cast(params["lm_head"], rt))
    logits = L.constrain(logits, rules, (L.BATCH, L.SEQ, L.VOCAB))
    if spec.final_softcap:
        logits = L._softcap(logits.float(), spec.final_softcap)
    return logits


@traced("model.embed")
def _embed(params: dict, tokens, rt: RuntimeCfg):
    return L.cast(embed_rows(params["embed"], tokens), rt)


def forward(params: dict, tokens, spec, rt: RuntimeCfg,
            rules: Optional[AxisRules] = None, *, frames=None, vision=None,
            positions=None) -> torch.Tensor:
    """Training / prefill forward: tokens [B, S] (on the parameters' device)
    -> logits [B, Sv + S, V].

    ``vision`` [B, Sv, H] (a VLM's patch embeddings) is cast to the compute
    dtype and prepended to the token embeddings.  ``frames`` [B, T, H] (an
    encoder's frame embeddings) are required when the spec has an encoder:
    the encoder runs over them and every decoder layer cross-attends to its
    output.

    Parameters placed on a mesh (DTensors) take plain inputs as
    replicated, and ``rules`` constrain the activations; the logits are a
    DTensor then."""
    _require_ported(spec)
    mesh = mesh_of(params)
    with on_mesh(mesh):
        tokens, frames, vision, positions = (
            replicated(t, mesh) for t in (tokens, frames, vision, positions))
        return _forward(params, tokens, spec, rt, rules, frames, vision,
                        positions)


def _forward(params, tokens, spec, rt, rules, frames, vision, positions):
    x = _embed(params, tokens, rt)
    x = L.constrain(x, rules, (L.BATCH, L.SEQ, L.EMB))
    if vision is not None:
        x = torch.cat([vision.to(x.dtype), x], dim=1)
    cross_kv = None
    if spec.encoder_layers:
        if frames is None:
            raise ValueError(f"{spec.name!r} has an encoder: forward needs "
                             "frames [B, T, H]")
        cross_kv = _run_encoder(params, frames, spec, rt, rules)
    prefix_n, period = layer_pattern(spec)
    for l, p in enumerate(params["prefix"]):
        def prefix_block(xc, pc, kind=_slot_kind(spec, l)):
            return _apply_slot(pc, xc, spec, rt, rules, kind,
                               positions=positions)[0]
        x = _remat(prefix_block, rt)(x, p)
    kinds = [_slot_kind(spec, prefix_n + s) for s in range(period)]

    def group(xc, r):
        """Repeat ``r`` of the period: its slots, each cross-attending with
        ``params["cross"][r]`` where the spec has an encoder."""
        cross_p = _index(params["cross"], r) if spec.encoder_layers else None
        for s in range(period):
            xc, _ = _apply_slot(_index(params["slots"][s], r), xc, spec, rt,
                                rules, kinds[s], positions=positions,
                                cross_kv=cross_kv, cross_p=cross_p)
        return xc

    for r in range(_n_rep(spec)):
        x = _remat(group, rt)(x, r)
    return _logits(params, x, spec, rt, rules)


def loss_fn(params: dict, batch: dict, spec, rt: RuntimeCfg,
            rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` (``tokens`` and ``labels``
    [B, S]; ``frames`` / ``vision`` where the spec takes them): fp32
    ``logsumexp`` minus the gold logit.  A VLM's logits are cut to the
    labelled positions (the vision prefix has no labels).  With
    ``rt.loss_chunk`` dividing S (and shorter), the sum runs over sequence
    chunks in order, each under ``checkpoint``, so that only one chunk's
    [B, chunk, V] fp32 working set is alive, as the JAX package's scan.
    On a mesh the loss is a DTensor; its backward must run under
    ``models.common.on_mesh`` too (``train.value_and_grad`` does)."""
    logits = forward(params, batch["tokens"], spec, rt, rules,
                     frames=batch.get("frames"), vision=batch.get("vision"))
    mesh = mesh_of(params)
    with on_mesh(mesh):
        return _loss(logits, replicated(batch["labels"], mesh), rt)


def _loss(logits, labels, rt: RuntimeCfg) -> torch.Tensor:
    if logits.shape[1] != labels.shape[1]:       # VLM: vision positions
        logits = logits[:, -labels.shape[1]:]
    b, s = labels.shape
    if rt.loss_chunk and s % rt.loss_chunk == 0 and s > rt.loss_chunk:
        tot = torch.zeros((), dtype=torch.float32, device=logits.device)
        for c0 in range(0, s, rt.loss_chunk):
            sl = slice(c0, c0 + rt.loss_chunk)
            tot = tot + checkpoint(_ce_sum, logits[:, sl], labels[:, sl],
                                   use_reentrant=False)
        return tot / (b * s)
    return _ce_sum(logits, labels) / (b * s)


def _ce_sum(logits, labels) -> torch.Tensor:
    """Sum over [B, S] of logsumexp(logits) - logits[label], in fp32.  On
    a DTensor the gold logits stay [B, S, 1] up to the sum: with the vocab
    sharded DTensor gathers them as a masked partial sum whose mask has the
    gather's shape, and a select would drop a dimension from under it."""
    lf = logits.float()
    gold = torch.gather(lf, -1, labels[..., None].long())
    if mesh_of(logits) is not None:
        return torch.sum(torch.logsumexp(lf, dim=-1, keepdim=True) - gold)
    return torch.sum(torch.logsumexp(lf, dim=-1) - gold[..., 0])


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------


def _slot_cache(spec, rt, kind: dict, lead: tuple, batch: int, kv_len: int,
                device) -> dict:
    cdt = dt(rt.compute_dtype)

    def zeros(*shape, dtype=cdt):
        return torch.zeros(lead + (batch,) + shape, dtype=dtype, device=device)

    nkv, dh = max(1, spec.n_kv_heads), spec.head_dim
    if kind["mixer"] == "rwkv":
        nh, H = spec.n_heads, spec.d_model
        c = {"rwkv": {"wkv": zeros(nh, dh, dh, dtype=torch.float32),
                      "shift_tm": zeros(H), "shift_cm": zeros(H)}}
    elif kind["mixer"] == "mamba":
        din = spec.ssm.expand * spec.d_model
        c = {"mamba": {"conv": zeros(3, din),
                       "ssm": zeros(din, spec.ssm.d_state,
                                    dtype=torch.float32)}}
    elif spec.block == "mla":
        # one latent row [ckv | kr] a position: the absorbed decode reads
        # the buffer whole as its key and its first kv_lora columns as its
        # value (layers.mla_attention)
        m = spec.mla
        latent = zeros(kv_len, m.kv_lora + m.rope_dim)
        c = {"attn": {"ckv": latent[..., :m.kv_lora],
                      "kr": latent[..., m.kv_lora:], "pos": 0}}
    else:
        klen = min(kv_len, spec.window) if kind["window"] else kv_len
        c = {"attn": {"k": zeros(klen, nkv, dh), "v": zeros(klen, nkv, dh),
                      "pos": 0}}
    if spec.encoder_layers:
        # filled by nothing, as in the JAX package: decode attends to zeros
        c["cross"] = {"k": zeros(spec.enc_seq, nkv, dh),
                      "v": zeros(spec.enc_seq, nkv, dh)}
    return c


def init_cache(spec, rt: RuntimeCfg, batch: int, kv_len: int, *,
               device=None) -> dict:
    """Empty decode cache on ``device``, per prefix layer and per slot of the
    period: for GQA attention, k and v stacked ``[n_rep, B, klen, NKV, DH]``
    and one integer ``pos`` shared by the stack's layers (the JAX package
    keeps ``pos`` as an ``[n_rep]`` array of equal entries); for MLA, the
    latent ``ckv [n_rep, B, kv_len, kv_lora]``, the rope key ``kr [n_rep, B,
    kv_len, rope_dim]`` and ``pos``, ``ckv`` and ``kr`` the column views of
    one ``[n_rep, B, kv_len, kv_lora + rope_dim]`` latent buffer; for RWKV6,
    the fp32 state ``wkv`` ``[n_rep, B, N, D, D]`` and the two token shifts
    ``[n_rep, B, H]`` in the compute dtype; for Mamba, the last three conv inputs ``conv [n_rep, B,
    3, Din]`` in the compute dtype and the fp32 state ``ssm [n_rep, B, Din,
    P]``.  A recurrent cache has no length: ``kv_len`` is not read.  With an
    encoder, every slot also holds the cross-attention's ``k`` and ``v``
    ``[n_rep, B, enc_seq, NKV, DH]``, zeros: as in the JAX package nothing
    fills them, so decode attends to zero keys and values."""
    _require_ported(spec)
    device = resolve_device(device)
    prefix_n, period = layer_pattern(spec)
    n_rep = _n_rep(spec)
    return {
        "prefix": [_slot_cache(spec, rt, _slot_kind(spec, l), (), batch,
                               kv_len, device) for l in range(prefix_n)],
        "slots": [_slot_cache(spec, rt, _slot_kind(spec, prefix_n + s),
                              (n_rep,), batch, kv_len, device) if n_rep else {}
                  for s in range(period)],
    }


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens, spec, rt: RuntimeCfg,
                rules: Optional[AxisRules] = None) -> tuple:
    """One decode step: tokens [B, S_new] -> (logits [B, S_new, V], cache).

    The cache's tensors (k and v; the RWKV6 and Mamba states) are **updated
    in place**; the returned cache shares them and carries the advanced
    ``pos``.  As in the JAX package, slot s of the period runs over all its
    repeats before slot s+1 starts (for period 1 that is plain layer order;
    jamba's period of 8 at 16 layers runs layers 0, 8, 1, 9, ...).  With an
    encoder, layer r of a slot cross-attends with ``params["cross"][r]``
    to its cached cross k and v.

    On a mesh (DTensor parameters) the cache must be DTensors on it too.  A
    layer's cache is a view of its row of each stacked leaf, except where
    the leaf is sharded over its layers dimension (the JAX package's cache
    heuristic does that where the depth divides the data degree): there a
    row is not a view but a copy, broadcast from the ranks that hold it,
    and after the layer those ranks write it back into their shard.  The
    stack is still updated in place, through its local shards."""
    _require_ported(spec)
    mesh = mesh_of(params)
    with on_mesh(mesh):
        return _decode(params, cache, replicated(tokens, mesh), spec, rt,
                       rules)


def _layer_sharded(t) -> bool:
    """Whether ``t`` is a DTensor sharded over its dimension 0."""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and any(
        isinstance(pl, Shard) and pl.dim == 0 for pl in t.placements)


def _local_rows(t) -> tuple:
    """(this rank's shard of the layer-sharded ``t``, its first row)."""
    _, offset = local_shape_and_offset(t.shape, t.device_mesh, t.placements)
    return t.to_local(), offset[0]


def _row(t, r: int):
    """Row ``r`` of a stacked cache leaf: a view, or for a leaf sharded over
    its layers dimension a copy, replicated where the stack was sharded:
    the ranks that hold the row contribute it and the others zeros to a
    sum over those mesh dimensions."""
    if not _layer_sharded(t):
        return t[r]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    local, lo = _local_rows(t)
    row = local[r - lo] if lo <= r < lo + local.shape[0] else \
        local.new_zeros(local.shape[1:])
    pl = [Partial() if isinstance(p, Shard) and p.dim == 0 else
          Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in t.placements]
    row = DTensor.from_local(row, t.device_mesh, pl, run_check=False,
                             shape=t.shape[1:], stride=t.stride()[1:])
    return row.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in pl])


def _put_row(t, r: int, row) -> None:
    """Write the layer-sharded leaf ``t``'s row ``r`` back from ``row``
    (``_row``'s copy, updated by the layer) on the ranks that hold it."""
    if not _layer_sharded(t):
        return
    local, lo = _local_rows(t)
    if lo <= r < lo + local.shape[0]:
        local[r - lo].copy_(row.to_local())


def _decode(params, cache, tokens, spec, rt, rules) -> tuple:
    x = _embed(params, tokens, rt)
    prefix_n, period = layer_pattern(spec)
    new_cache: dict = {"prefix": [], "slots": []}
    for l, (p, c) in enumerate(zip(params["prefix"], cache["prefix"])):
        x, nc = _apply_slot(p, x, spec, rt, rules, _slot_kind(spec, l),
                            cache=c)
        new_cache["prefix"].append(nc)

    for s in range(period):
        stack = cache["slots"][s]
        if not params["slots"][s]:
            new_cache["slots"].append({})
            continue
        kind = _slot_kind(spec, prefix_n + s)
        nc = stack
        for r in range(_n_rep(spec)):
            layer_cache = _tree_map(
                lambda t: _row(t, r) if isinstance(t, torch.Tensor) else t,
                stack)
            cross_p = _index(params["cross"], r) if spec.encoder_layers \
                else None
            x, nc = _apply_slot(_index(params["slots"][s], r), x, spec, rt,
                                rules, kind, cache=layer_cache,
                                cross_p=cross_p,
                                cross_cache=layer_cache.get("cross"))
            _tree_map(lambda t, row: _put_row(t, r, row)
                      if isinstance(t, torch.Tensor) else None,
                      stack, layer_cache)
        # the stacked tensors were written in place; ``pos`` (attention)
        # is the last layer's
        new_cache["slots"].append(_tree_map(
            lambda t, t_new: t if isinstance(t, torch.Tensor) else t_new,
            stack, nc))
    return _logits(params, x, spec, rt), new_cache
