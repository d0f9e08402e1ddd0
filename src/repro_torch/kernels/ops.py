"""Public wrappers adapting model-layout tensors to the kernels.

The kernels are forward only: none has a backward, as none of the JAX
package's Pallas kernels has one.  So each entry here refuses to be
differentiated: under grad mode, a floating input that requires grad raises
a ``RuntimeError`` naming the kernel, on every device (on the card the
kernel writes into a fresh tensor through ``ctypes`` and autograd would lose
the graph without a word).  Training goes through the plain PyTorch paths
the models choose by their runtime config (``attention_impl="chunked"``).

On a mesh (DTensor inputs, ``repro_torch.parallel``) the kernels read
``data_ptr()``, so no DTensor reaches them: an entry redistributes to
``Replicate`` every dimension its kernel cannot split (attention's query
and key sequences and head dims, wkv6's sequence and head dim,
cost_reduce's T, the selective scan's sequence and states; GSPMD gathers
there too), runs the kernel on each rank's local shard, split over batch
and heads only (cost_reduce: over B and G; the selective scan: over batch
and channels), and returns DTensors with those placements.  Plain tensors
met there are taken as replicated."""
from __future__ import annotations

from typing import Optional

import torch

from ..models.common import as_global, copy_into, replicated, settle
from . import cost_reduce as _cr
from . import flash_attention as _fa
from . import rwkv6_scan as _wkv
from . import selective_scan as _ss

# the dtypes the attention kernel reads q, k and v in; a caller casts others
FLASH_INPUT_DTYPES = _fa.INPUT_DTYPES


def _refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would have to differentiate ``kernel``."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors
           if t is not None and t.is_floating_point()):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward and an input requires "
            "grad; train through attention_impl='chunked' (the plain "
            "PyTorch paths), or call it under torch.no_grad()")


def _is_dtensor(*tensors) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


def _mesh_inputs(*tensors) -> tuple:
    """(mesh, the tensors as DTensors on it: plain ones replicated)."""
    from torch.distributed.tensor import DTensor
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    return mesh, tuple(replicated(t, mesh) for t in tensors)


def _kept(placements, dims: dict) -> tuple:
    """``placements`` with each ``Shard(d)`` for d in ``dims`` renamed to
    ``Shard(dims[d])`` and every other placement ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in placements:
        d = dims.get(pl.dim) if isinstance(pl, Shard) else None
        out.append(Shard(d) if d is not None else Replicate())
    return tuple(out)


def _local(t, placements) -> torch.Tensor:
    """This rank's shard of ``t`` laid out by ``placements`` (on a mesh
    dimension of one rank, by its own)."""
    return settle(t, placements).to_local()


def cost_reduce(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched cost reduction ``out[b, e] = sum_t x[b, t] * w[e, t]``: the
    busy-group contraction of the batched DSE backend, x [B, K] per-slot
    durations, w [G, K] static membership rows -> [B, G] in x's dtype.

    w is cast to x's dtype, as the JAX wrapper does.  Unlike there, the
    sums run in x's own dtype on the card too (float64 on the batched
    backend's default path, which its 1e-6 parity budget needs; a half x
    in float32); on the CPU the plain version does the same."""
    _refuse_grad("cost_reduce", x, w)
    if _is_dtensor(x, w):
        mesh, (x, w) = _mesh_inputs(x, w)
        from torch.distributed.tensor import Replicate
        xp = _kept(x.placements, {0: 0})
        # G splits over a mesh dimension that B does not
        wp = tuple(Replicate() if a.is_shard() else b
                   for a, b in zip(xp, _kept(w.placements, {0: 0})))
        out_p = tuple(a if a.is_shard() else _kept([b], {0: 1})[0]
                      for a, b in zip(xp, wp))
        out = _cr.cost_reduce_bet(_local(x, xp), _local(w, wp))
        return as_global(out, mesh, out_p, (x.shape[0], w.shape[0]))
    return _cr.cost_reduce_bet(x, w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Model-layout flash attention: q [B,S,N,G,D], k/v [B,Sk,N,D].

    The kernel reads this layout by strides, so unlike the JAX wrapper there
    is no transpose and no G-fold repeat of k and v on the way in."""
    _refuse_grad("flash_attention", q, k, v)
    if _is_dtensor(q, k, v):
        mesh, (q, k, v) = _mesh_inputs(q, k, v)
        # batch, kv heads and q's group split; k and v follow q's batch
        # and kv heads
        qp = _kept(q.placements, {0: 0, 2: 2, 3: 3})
        kvp = _kept(qp, {0: 0, 2: 2})
        out = _fa.flash_attention(
            _local(q, qp), _local(k, kvp), _local(v, kvp),
            causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        return as_global(out, mesh, qp, tuple(q.shape[:4]) + (v.shape[-1],))
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor, *, chunk: int = 32,
         state_out: Optional[torch.Tensor] = None) -> tuple:
    """Model-layout RWKV6 scan: r/k/v/w [B,S,N,D], u [N,D], state0
    [B,N,D,D] -> (out [B,S,N,D] fp32, final state).

    The kernel reads this layout by strides, so unlike the JAX wrapper there
    are no transposes.  ``state_out`` (the port's addition) receives the final
    state and may be ``state0`` itself, which is then updated in place."""
    _refuse_grad("wkv6", r, k, v, w, u, state0)
    if _is_dtensor(r, k, v, w, u, state0):
        mesh, (r, k, v, w, u, state0) = _mesh_inputs(r, k, v, w, u, state0)
        rp = _kept(r.placements, {0: 0, 2: 2})           # batch, heads
        up = _kept(rp, {2: 0})
        sp = _kept(rp, {0: 0, 2: 1})
        in_place = state_out is not None and _is_dtensor(state_out) \
            and tuple(state_out.placements) == sp
        out, st = _wkv.wkv6(
            *(_local(t, rp) for t in (r, k, v, w)), _local(u, up),
            _local(state0, sp), chunk=chunk,
            state_out=state_out.to_local() if in_place else None)
        st = as_global(st, mesh, sp, state0.shape)
        if state_out is not None and not in_place:
            st = copy_into(state_out, st)
        elif in_place:
            st = state_out
        return as_global(out, mesh, rp, r.shape), st
    return _wkv.wkv6(r, k, v, w, u, state0, chunk=chunk, state_out=state_out)


def selective_scan(dtt: torch.Tensor, xc: torch.Tensor, Bt: torch.Tensor,
                   Ct: torch.Tensor, A_log: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   state: bool = True) -> tuple:
    """The Mamba mixer's selective scan: dtt [B,S,Din] fp32, xc [B,S,Din],
    Bt/Ct [B,S,P] (strided views of the layer's ``xdb`` as they are), A_log
    [Din,P], h0 [B,Din,P] or None (zero) -> (y [B,S,Din] in xc's dtype,
    last state fp32 or None).  The JAX package has no kernel here; see
    ``kernels/selective_scan.py``."""
    _refuse_grad("selective_scan", dtt, xc, Bt, Ct, A_log, h0)
    if _is_dtensor(dtt, xc, Bt, Ct, A_log, h0):
        mesh, (dtt, xc, Bt, Ct, A_log, h0) = _mesh_inputs(
            dtt, xc, Bt, Ct, A_log, h0)
        # channels are independent: batch rows and channels split, B and C
        # follow the batch rows, A_log the channels
        xp = _kept(xc.placements, {0: 0, 2: 2})
        bcp, ap, hp = _kept(xp, {0: 0}), _kept(xp, {2: 0}), \
            _kept(xp, {0: 0, 2: 1})
        y, h = _ss.selective_scan(
            _local(dtt, xp), _local(xc, xp), _local(Bt, bcp),
            _local(Ct, bcp), _local(A_log, ap),
            None if h0 is None else _local(h0, hp), state=state)
        b, _, d = xc.shape
        return as_global(y, mesh, xp, xc.shape), None if h is None else \
            as_global(h, mesh, hp, (b, d, A_log.shape[1]))
    return _ss.selective_scan(dtt, xc, Bt, Ct, A_log, h0, state=state)
