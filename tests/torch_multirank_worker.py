"""Checks of the port on a (2, 4) ("data", "model") DeviceMesh of 8 gloo
ranks on the CPU, each against the single-device result on the same inputs.

    PYTHONPATH=src python tests/torch_multirank_worker.py OUT.json

spawns the 8 ranks (a FileStore in a temporary directory, no network),
runs every check on all of them (the checks make collectives) and writes
``{check: {"ok": bool, "detail": ...}}`` from rank 0 to OUT.json.
``tests/test_torch_multirank.py`` runs it in a subprocess, so that no
process group ever lives in a pytest worker.  Inputs come from numpy with a
seed; fp32 throughout."""
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD, SHAPE, NAMES = 8, (2, 4), ("data", "model")
# fp32, the same arithmetic in another order: the EP branch within
# 1e-5 * max|single-device| + 1e-6, every train-step leaf within
# 1e-4 * max|leaf| + 1e-6 (the train tests' bound), the loss 1e-5 relative
EP_TOL, STEP_TOL, LOSS_REL = (1e-5, 1e-6), (1e-4, 1e-6), 1e-5
# the train tests' optimizer: eps 1e-3 bounds how far Adam's first update
# moves with a gradient's last digits
STEP_OPT = dict(lr=1e-2, warmup=2, eps=1e-3)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _worst(got, want, tol) -> float:
    """max over leaf pairs of |got - want| / (tol[0] * max|want| + tol[1])."""
    return max(float((_full(g).detach() - w).abs().max())
               / (tol[0] * float(w.abs().max()) + tol[1])
               for g, w in zip(got, want))


def _moe_setup():
    from repro_torch.core import ModelSpec, MoESpec
    from repro_torch.models import RuntimeCfg, init_params, lm, param_axes
    # the reference's multi-device test's spec; capacity 8: nothing drops,
    # so a shard's local capacity cannot drop what the single device keeps
    spec = ModelSpec(name="m", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab=256,
                     moe=MoESpec(8, 2, 0, 32))
    rt = RuntimeCfg(attention_impl="naive", moe_capacity=8.0,
                    param_dtype="float32", compute_dtype="float32")
    params = init_params(spec, rt, device="cpu", seed=0)
    moe = lm._index(params["slots"][0], 0)["moe"]
    axes = {k: v[1:] for k, v in param_axes(spec)["slots"][0]["moe"].items()}
    return spec, rt, moe, axes


def check_ep_moe(mesh, fsdp: bool, seq: int):
    """The expert-parallel moe_ffn (all-to-all over model = 4, ZeRO-3
    gathers over data = 2 with FSDP) against the single-device one: the
    output and the gradients of x and of every expert weight.  seq 16:
    tokens split over data and model; seq 1 (decode): over data only, every
    model peer routing the same tokens."""
    from repro_torch.models import AxisRules
    from repro_torch.models import layers as L
    from repro_torch.models.common import replicated
    from repro_torch.parallel import (distribute, logical_rules,
                                      param_shardings)
    from repro_torch.train.tree import leaves, unflatten
    spec, rt, moe, axes = _moe_setup()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, seq, 64)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((8, seq, 64))
                           .astype(np.float32))
    rules_d = logical_rules(sp=False, data_axes=("data",), fsdp=fsdp)
    rules = AxisRules(rules_d, mesh)

    def run(p, xin, r):
        flat = [t.detach().requires_grad_(True) for t in leaves(p)]
        xin = xin.detach().requires_grad_(True)
        out = L.moe_ffn(unflatten(p, flat), xin, spec, rt, r)
        cot_in = cot if r is None else replicated(cot, mesh)
        grads = torch.autograd.grad((out * cot_in).sum(), [xin] + flat)
        return out, grads
    ref, ref_g = run(moe, x, None)
    dmoe = distribute(moe, param_shardings(moe, axes, rules_d, mesh))
    dx = distribute(x, param_shardings(x, (L.BATCH, L.SEQ, L.EMB), rules_d,
                                       mesh))
    out, g = run(dmoe, dx, rules)
    placements = {k: str(v.placements) for k, v in dmoe.items()
                  if k.startswith("w_e")}
    return {"out": _worst([out], [ref.detach()], EP_TOL),
            "grads": _worst(g, ref_g, EP_TOL), "weights": placements}


def _train_setup(name, remat, fsdp, mesh):
    from repro_torch.configs import get
    from repro_torch.models import AxisRules, RuntimeCfg, init_params, \
        param_axes
    from repro_torch.parallel import (distribute, logical_rules,
                                      param_shardings)
    spec = get(name).smoke
    rt = RuntimeCfg(attention_impl="chunked", param_dtype="float32",
                    compute_dtype="float32", attn_chunk=8, moe_capacity=8.0,
                    remat=remat)
    params = init_params(spec, rt, device="cpu", seed=0)
    axes = param_axes(spec)
    rules_d = logical_rules(sp=True, data_axes=("data",), fsdp=fsdp)
    dparams = distribute(params, param_shardings(params, axes, rules_d, mesh))
    return spec, rt, params, axes, rules_d, AxisRules(rules_d, mesh), dparams


def check_train_step(mesh, name: str, remat: str, fsdp: bool):
    """Loss and every gradient (value_and_grad), then one make_train_step
    (AdamW) with DTensor parameters and ZeRO-1 moments, against the plain
    step; sequence parallelism on.  The moments must keep their ZeRO-1
    placements."""
    from repro_torch.parallel import distribute, spec_placements
    from repro_torch.train import (OptCfg, init_opt_state, make_train_step,
                                   opt_state_shardings)
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.tree import leaves
    spec, rt, params, axes, rules_d, rules, dparams = _train_setup(
        name, remat, fsdp, mesh)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, spec.vocab, (2, 16)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    loss, grads = value_and_grad(params, batch, spec, rt)
    dloss, dgrads = value_and_grad(dparams, batch, spec, rt, rules)
    shard = opt_state_shardings(params, axes, rules_d, mesh,
                                data_axes=("data",))
    opt = init_opt_state(params)
    dopt = distribute(init_opt_state(dparams), shard)
    new_p, new_o, m = make_train_step(spec, rt, OptCfg(**STEP_OPT))(
        params, opt, batch)
    dnew_p, dnew_o, dm = make_train_step(spec, rt, OptCfg(**STEP_OPT),
                                         rules)(dparams, dopt, batch)
    want_pl = [spec_placements(s.spec, mesh) for s in _sh_leaves(shard["m"])]
    kept = all(tuple(t.placements) == pl
               for key in ("m", "v")
               for t, pl in zip(leaves(dnew_o[key]), want_pl))
    zero1 = sum(any(str(p) != str(q) for p, q in zip(t.placements,
                                                      pt.placements))
                for t, pt in zip(leaves(dnew_o["m"]), leaves(dparams)))
    return {"loss_rel": abs(float(dloss) - float(loss)) / abs(float(loss)),
            "step_loss_rel": abs(float(dm["loss"]) - float(m["loss"]))
            / abs(float(m["loss"])),
            "grads": _worst(leaves(dgrads), leaves(grads), STEP_TOL),
            "params": _worst(leaves(dnew_p), leaves(new_p), STEP_TOL),
            "moments": max(_worst(leaves(dnew_o[k]), leaves(new_o[k]),
                                  STEP_TOL) for k in ("m", "v")),
            "grad_norm_rel": abs(float(dm["grad_norm"])
                                 - float(m["grad_norm"]))
            / float(m["grad_norm"]),
            "moments_keep_zero1": kept,
            "moments_sharded_beyond_params": zero1,
            "step": int(_full(dnew_o["step"]))}


def _sh_leaves(tree) -> list:
    """The ``NamedSharding`` leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sh_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _sh_leaves(v)]
    return [tree]


def check_decode(mesh, name: str, impl: str):
    """An Engine with rules over DTensor parameters (cache placed by the
    engine: batch over data) answers the same requests with the same greedy
    tokens as the plain engine; with ``impl="cuda"`` every attention goes
    through the kernel entry, which on the CPU runs the plain version on
    each rank's local shard."""
    from repro_torch.serve.engine import Engine, Request, make_prefill
    spec, rt, params, _, _, rules, dparams = _train_setup(
        name, "none", get_fsdp(name), mesh)
    import dataclasses
    rt = dataclasses.replace(rt, attention_impl=impl)
    outs = []
    for p, r in ((params, None), (dparams, rules)):
        eng = Engine(spec, rt, p, batch_slots=4, kv_len=16, device="cpu",
                     rules=r)
        rng = np.random.default_rng(0)
        for i in range(4):
            eng.submit(Request(i, rng.integers(0, spec.vocab, 3), max_new=3))
        outs.append({q.rid: q.out for q in eng.run(max_steps=16)})
    tok = torch.from_numpy(np.random.default_rng(1)
                           .integers(0, spec.vocab, (4, 8)))
    want = make_prefill(spec, rt)(params, tok)
    got = make_prefill(spec, rt, rules)(dparams, tok)
    return {"tokens_equal": outs[0] == outs[1] and len(outs[0]) == 4,
            "prefill": _worst([got], [want], STEP_TOL)}


def get_fsdp(name):
    from repro_torch.configs import get
    return get(name).smoke.moe is not None


def check_kernel_entries(mesh):
    """The kernel entries on DTensors sharded over batch, heads (the
    selective scan: channels) and the sequence: no DTensor reaches the
    kernel wrapper (on the CPU its plain version), the sequence and head
    dims arrive whole, the result equals the plain call and keeps the batch
    / head (channel) shards."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.kernels import cost_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import selective_scan as ss
    seen = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*args, **kw):
            seen.append([type(a).__name__ for a in args
                         if isinstance(a, torch.Tensor)])
            return real(*args, **kw)
        setattr(mod, name, wrapped)
        return real
    reals = [(fa, "flash_attention", spy(fa, "flash_attention")),
             (wkv, "wkv6", spy(wkv, "wkv6")),
             (cr, "cost_reduce_bet", spy(cr, "cost_reduce_bet")),
             (ss, "selective_scan", spy(ss, "selective_scan"))]
    try:
        rng = np.random.default_rng(2)

        def arr(*shape):
            return torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))

        def dt(t, *pl):
            return distribute_tensor(t, mesh, list(pl), src_data_rank=None)
        q, k, v = arr(4, 16, 4, 2, 8), arr(4, 16, 4, 8), arr(4, 16, 4, 8)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        got = ops.flash_attention(dt(q, Shard(0), Shard(1)),
                                  dt(k, Shard(0), Shard(2)),
                                  dt(v, Shard(1), Shard(2)), causal=True)
        att = {"err": _worst([got], [want], (2e-5, 2e-5)),
               "placements": str(got.placements)}
        r, kk, vv = arr(2, 16, 4, 8), arr(2, 16, 4, 8), arr(2, 16, 4, 8)
        w = torch.exp(-torch.exp(arr(2, 16, 4, 8)))
        u, s0 = arr(4, 8), arr(2, 4, 8, 8)
        want_o, want_s = wkv.wkv6_plain(r, kk, vv, w, u, s0, chunk=8)
        out, st = ops.wkv6(dt(r, Shard(0), Shard(2)), dt(kk, Shard(0),
                                                         Shard(1)),
                           vv, dt(w, Shard(0), Shard(2)), u,
                           dt(s0, Shard(0), Shard(1)), chunk=8)
        wk = {"err": _worst([out, st], [want_o, want_s], (1e-4, 1e-5)),
              "placements": str(out.placements)}
        x, wt = arr(6, 32).double(), arr(8, 32).double()
        got = ops.cost_reduce(dt(x, Shard(1), Shard(0)),
                              dt(wt, Shard(0), Shard(1)))
        cost = {"err": _worst([got], [cr.cost_reduce_plain(x, wt)],
                              (1e-12, 1e-12)),
                "placements": str(got.placements)}
        # B and C strided views of one xdb; the state sharded over channels
        dtt = torch.nn.functional.softplus(arr(2, 16, 8))
        xc, xdb = arr(2, 16, 8), arr(2, 16, 11)
        a_log, h0 = torch.log1p(15 * torch.sigmoid(arr(8, 4))), arr(2, 8, 4)
        bt, ct = xdb[..., 3:7], xdb[..., 7:]
        want_y, want_h = ss.selective_scan_plain(dtt, xc, bt, ct, a_log, h0)
        dxdb = dt(xdb, Shard(0), Shard(1))
        y, h = ops.selective_scan(dt(dtt, Shard(0), Shard(2)),
                                  dt(xc, Shard(1), Shard(2)), dxdb[..., 3:7],
                                  dxdb[..., 7:], a_log,
                                  dt(h0, Shard(0), Shard(1)))
        scan = {"err": _worst([y, h], [want_y, want_h], (1e-5, 1e-5)),
                "placements": str(y.placements),
                "state_placements": str(h.placements)}
    finally:
        for mod, name, real in reals:
            setattr(mod, name, real)
    return {"flash": att, "wkv6": wk, "cost_reduce": cost,
            "selective_scan": scan, "calls": len(seen),
            "dtensor_reached": any("DTensor" in c for c in seen)}


def check_checkpoint(mesh, tmp: str, rank: int):
    """save of a DTensor state writes the plain state's bytes; restore with
    ``shardings=`` gives DTensors with those placements and the saved
    values, bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import restore, save
    from repro_torch.parallel import distribute
    from repro_torch.train import init_opt_state, opt_state_shardings
    from repro_torch.train.tree import leaves
    spec, rt, params, axes, rules_d, _, dparams = _train_setup(
        "deepseek-moe-16b", "none", True, mesh)
    from repro_torch.parallel import param_shardings
    osh = opt_state_shardings(params, axes, rules_d, mesh,
                              data_axes=("data",))
    shardings = {"params": param_shardings(params, axes, rules_d, mesh),
                 "opt": osh}
    plain = {"params": params, "opt": init_opt_state(params)}
    for t in leaves(plain["opt"]["m"]):
        t.normal_(generator=torch.Generator().manual_seed(3))
    state = distribute(plain, shardings)
    d_plain = save(os.path.join(tmp, f"plain{rank}"), 1, plain)
    d_mesh = save(os.path.join(tmp, f"mesh{rank}"), 1, state)

    def read(d):
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d))}
    same_bytes = read(d_plain) == read(d_mesh)
    back, step = restore(os.path.join(tmp, f"mesh{rank}"), plain,
                         device="cpu", shardings=shardings)
    placed = all(isinstance(t, DTensor) for t in leaves(back))
    same_pl = all(tuple(a.placements) == tuple(b.placements)
                  for a, b in zip(leaves(back), leaves(state)))
    bit_equal = all(torch.equal(_full(a), b)
                    for a, b in zip(leaves(back), leaves(plain)))
    return {"same_bytes": same_bytes, "dtensors": placed,
            "placements_equal": same_pl, "bit_equal": bit_equal,
            "step": step}


def check_refusals(mesh):
    """What must raise on a real mesh: the production mesh on a world of 8
    and a spec tuple out of mesh order.  And what decodes: a cache whose
    stacks the JAX package's heuristic shards over their layers dimension
    (``dryrun._cache_shardings(buggy=True)``, which does that where the
    depth divides the data degree)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import spec_placements
    out = {}
    try:
        make_production_mesh()
        out["production"] = "built"
    except ValueError as e:
        out["production"] = str(e)
    try:
        spec_placements((("model", "data"),), mesh)
        out["order"] = "accepted"
    except ValueError as e:
        out["order"] = str(e)
    out["rows"] = check_layer_sharded_decode(mesh)
    return out


def check_layer_sharded_decode(mesh):
    """Six greedy decode steps through a cache whose stacks are sharded over
    their layers dimension (2 layers over data = 2) against the same steps
    through a replicated cache: the same tokens, logits and cache."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import _cache_shardings
    from repro_torch.models import (RuntimeCfg, init_cache, init_params, lm,
                                    param_axes)
    from repro_torch.models.common import _tree_map
    from repro_torch.parallel import (NamedSharding, distribute,
                                      logical_rules, param_shardings)
    from repro_torch.train.tree import leaves
    spec = dataclasses.replace(get("qwen3-14b").smoke, n_layers=2)
    rt = RuntimeCfg(attention_impl="naive", param_dtype="float32",
                    compute_dtype="float32")
    params = init_params(spec, rt, device="cpu", seed=0)
    rules_d = logical_rules(data_axes=("data",))
    dparams = distribute(params, param_shardings(params, param_axes(spec),
                                                 rules_d, mesh))
    empty = init_cache(spec, rt, 4, 16, device="cpu")
    by_layers = _cache_shardings(empty, mesh, batch=4, buggy=True)
    whole_cache = _tree_map(lambda _: NamedSharding(mesh, ()), empty)
    start = torch.from_numpy(np.random.default_rng(3)
                             .integers(0, spec.vocab, (4, 1)))

    def greedy(shardings):
        cache = distribute(init_cache(spec, rt, 4, 16, device="cpu"),
                           shardings)
        tok, toks, logits = start, [], []
        for _ in range(6):
            out, cache = lm.decode_step(dparams, cache, tok, spec, rt)
            out = _full(out)
            tok = out[:, -1].argmax(-1, keepdim=True)
            toks.append(tok.flatten().tolist())
            logits.append(out)
        return toks, logits, [_full(t) for t in leaves(cache)
                              if isinstance(t, torch.Tensor)]
    sharded = greedy(by_layers)
    replicated = greedy(whole_cache)
    return {"layer_sharded_leaves": sum(
                s.spec[:1] == (("data",),) for s in _sh_leaves(by_layers)),
            "tokens_equal": sharded[0] == replicated[0],
            "logits_equal": all(torch.equal(a, b) for a, b in
                                zip(sharded[1], replicated[1])),
            "cache_equal": len(sharded[2]) == len(replicated[2]) > 0 and all(
                torch.equal(a, b) for a, b in zip(sharded[2], replicated[2])),
            "tokens": sharded[0]}


# every family's smoke spec for the seq-sharded decode cache; gemma2's
# window widened to 32 (over 4 ranks, 8 entries a shard) and qwen3's and
# rwkv6's stacks cut to 2 layers, so that the heuristics shard the ring's
# sequence (the largest dim: not the head dim, 16) and the layer stacks (a
# depth the data degree divides)
SEQ_FAMILIES = {"qwen3-14b": {"n_layers": 2}, "gemma2-27b": {"window": 32},
                "deepseek-v2-236b": {}, "deepseek-moe-16b": {},
                "jamba-v0.1-52b": {}, "rwkv6-7b": {"n_layers": 2},
                "whisper-medium": {}}
SEQ_KV, SEQ_PROMPT, SEQ_STEPS = 64, 14, 6


def _with_seq(by_layers, by_seq):
    """The layer-stack heuristic's shardings with the kv-sequence one's
    ``model`` added on the dim it shards, where that dim is still free."""
    from repro_torch.parallel import NamedSharding
    if isinstance(by_layers, dict):
        return {k: _with_seq(v, by_seq[k]) for k, v in by_layers.items()}
    if isinstance(by_layers, list):
        return [_with_seq(a, b) for a, b in zip(by_layers, by_seq)]
    spec = list(by_layers.spec) + [None] * (len(by_seq.spec)
                                            - len(by_layers.spec))
    for d, e in enumerate(by_seq.spec):
        if e == "model" and spec[d] is None:
            spec[d] = e
    return NamedSharding(by_layers.mesh, tuple(spec))


def check_seq_sharded_decode(mesh, name: str):
    """Six greedy decode steps through a cache whose largest dim past the
    batch (the kv-sequence of attention caches, gemma2's ring included; the
    channels of the Mamba and RWKV6 states) is sharded over model
    (``dryrun._cache_shardings(seq_axis="model")``), alone and combined with
    the layer-stack heuristic (``buggy=True``), against the same steps
    through a replicated cache.  The first step feeds a 14-token prompt, the
    second 3 tokens at positions 14-16, across the boundary of the first
    two sequence shards (16 entries each).  With ``attention_impl="naive"``
    the scores are summed over the key shards (another order: within
    EP_TOL); through the kernel entry (``"cuda"``, its plain version on the
    CPU) the keys are gathered first."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.launch.dryrun import _cache_shardings
    from repro_torch.models import (RuntimeCfg, init_cache, init_params, lm,
                                    param_axes)
    from repro_torch.models.common import _tree_map
    from repro_torch.parallel import (NamedSharding, distribute,
                                      logical_rules, param_shardings)
    from repro_torch.train.tree import leaves
    spec = dataclasses.replace(get(name).smoke, **SEQ_FAMILIES[name])
    rt = RuntimeCfg(attention_impl="naive", param_dtype="float32",
                    compute_dtype="float32")
    params = init_params(spec, rt, device="cpu", seed=0)
    rules_d = logical_rules(data_axes=("data",))
    dparams = distribute(params, param_shardings(params, param_axes(spec),
                                                 rules_d, mesh))
    empty = init_cache(spec, rt, 4, SEQ_KV, device="cpu")
    by_seq = _cache_shardings(empty, mesh, batch=4, seq_axis="model")
    by_seq_layers = _with_seq(_cache_shardings(empty, mesh, buggy=True),
                              by_seq)
    whole_cache = _tree_map(lambda _: NamedSharding(mesh, ()), empty)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, spec.vocab, (4, SEQ_PROMPT)))
    extra = torch.from_numpy(rng.integers(0, spec.vocab, (4, 2)))

    def greedy(shardings, impl):
        run_rt = dataclasses.replace(rt, attention_impl=impl)
        cache = distribute(init_cache(spec, rt, 4, SEQ_KV, device="cpu"),
                           shardings)
        tok, toks, logits = prompt, [], []
        for i in range(SEQ_STEPS):
            out, cache = lm.decode_step(dparams, cache, tok, spec, run_rt)
            out = _full(out)
            tok = out[:, -1].argmax(-1, keepdim=True)
            toks.append(tok.flatten().tolist())
            logits.append(out)
            if i == 0:
                tok = torch.cat([tok, extra], dim=1)
        return toks, logits, [_full(t) for t in leaves(cache)
                              if isinstance(t, torch.Tensor)]

    def vs(got, want):
        return {"tokens_equal": got[0] == want[0],
                "logits": _worst(got[1], want[1], EP_TOL),
                "cache": _worst(got[2], want[2], EP_TOL),
                "bit_equal": all(torch.equal(a, b) for a, b in
                                 zip(got[1] + got[2], want[1] + want[2]))}
    want = {impl: greedy(whole_cache, impl) for impl in ("naive", "cuda")}
    specs = [s.spec for s in _sh_leaves(by_seq_layers)]
    return {"seq": vs(greedy(by_seq, "naive"), want["naive"]),
            "seq_layers": vs(greedy(by_seq_layers, "naive"), want["naive"]),
            "seq_kernel_entry": vs(greedy(by_seq, "cuda"), want["cuda"]),
            "seq_layers_kernel_entry": vs(greedy(by_seq_layers, "cuda"),
                                          want["cuda"]),
            "model_sharded_leaves": sum("model" in s for s in specs),
            "layer_and_model_sharded_leaves": sum(
                "model" in s and s[:1] == (("data",),) for s in specs),
            "tokens": want["naive"][0]}


CHECKS = {
    "ep_moe[seq16]": lambda m, **_: check_ep_moe(m, False, 16),
    "ep_moe[seq16-fsdp-gather]": lambda m, **_: check_ep_moe(m, True, 16),
    "ep_moe[decode]": lambda m, **_: check_ep_moe(m, False, 1),
    "ep_moe[decode-fsdp-gather]": lambda m, **_: check_ep_moe(m, True, 1),
    "train_step[dense]": lambda m, **_: check_train_step(
        m, "qwen3-14b", "none", False),
    "train_step[moe]": lambda m, **_: check_train_step(
        m, "deepseek-moe-16b", "full", True),
    "decode[dense-kernel-entry]": lambda m, **_: check_decode(
        m, "qwen3-14b", "cuda"),
    "decode[moe-chunked]": lambda m, **_: check_decode(
        m, "deepseek-moe-16b", "chunked"),
    "kernel_entries": lambda m, **_: check_kernel_entries(m),
    "checkpoint": lambda m, tmp, rank: check_checkpoint(m, tmp, rank),
    "refusals": lambda m, **_: check_refusals(m),
    **{f"seq_cache[{n}]": (lambda m, n=n, **_: check_seq_sharded_decode(m, n))
       for n in SEQ_FAMILIES},
}


def _rank(rank: int, store_file: str, tmp: str, out_path: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(SHAPE, NAMES, device="cpu", rank=rank,
                     init_file=store_file)
    results = {}
    try:
        for name, fn in CHECKS.items():
            t0 = time.perf_counter()
            try:
                results[name] = {"ok": True, "detail": fn(mesh, tmp=tmp,
                                                          rank=rank)}
            except Exception:
                results[name] = {"ok": False,
                                 "detail": traceback.format_exc()}
            results[name]["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, default=str)


def main(out_path: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), tmp, out_path),
                 nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])
