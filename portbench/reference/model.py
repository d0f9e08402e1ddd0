"""A full forward pass of a cell's model in plain PyTorch, layer after
layer, in float32 with TF32 off (``precision="fp32"``), or with every
product's operands rounded to float8 e4m3 with a per-tensor scale and the
fp32 leaves to bfloat16 (``precision="fp8"``: the output check's control).

The model is the port's definition of the configuration: the source's
keys, and the departures its file lists (capacity-limited top-k routing
with gates renormalised over the K picks, RoPE on every attention layer,
a Mamba mixer without the dt / B / C norms and biases).  Each layer runs
the ``reference`` of its kinds (``weights.kinds``): the methods below for
the harness's own, a module of layer kinds' functions for the kinds it
adds.

Two groupings of the MoE capacity:

* ``"batch"``: all B x T tokens form one dispatch, in row-major order
  (a prefill);
* ``"step"``: the B tokens of each position form one dispatch, in batch
  order (a serving engine's decode steps, one token per slot a step).

Attention is causal over the positions 0..T-1 of each row, and the Mamba
scan starts from a zero state and zero conv inputs: the history of a slot
of an engine that was never reset, replayed from its first step."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import weights as W

ATTN_Q_BLOCK = 1024          # query rows per block of attention scores
SCAN_CHUNK = 128             # time steps whose dA / dBx are made at once
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: dict, tree: dict, precision: str = "fp32",
                 capacity_factor: float = 1.25):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 | fp8")
        no_tf32()
        self.cfg, self.tree, self.precision = cfg, tree, precision
        self.cf = capacity_factor
        self.eps = cfg["rms_norm_eps"]

    # -- operands ---------------------------------------------------------
    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight as the reference computes with it."""
        t = t.float()
        if self.precision == "fp8":
            return _fp8(t)
        return t

    def w32(self, t: torch.Tensor) -> torch.Tensor:
        """A leaf the configuration states in float32 (router, A_log)."""
        t = t.float()
        if self.precision == "fp8":
            return t.to(torch.bfloat16).float()
        return t

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a product with a weight."""
        return _fp8(x) if self.precision == "fp8" else x

    def mm(self, x, w):
        return self.a(x) @ self.w(w)

    def norm(self, x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * w.float()

    def layer(self, l: int) -> dict:
        where, i, r = W.layer_place(self.cfg, l)
        if where == "prefix":
            return self.tree["prefix"][i]
        return _row(self.tree["slots"][i], r)

    # -- the model --------------------------------------------------------
    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor, grouping: str) -> torch.Tensor:
        """tokens [B, T] -> the final normed hidden states [B, T, H]."""
        x = self.tree["embed"][tokens].float()
        if self.precision == "fp8":
            x = _fp8(x)
        table = W.kinds(self.cfg)
        for l in range(self.cfg["num_hidden_layers"]):
            p = self.layer(l)
            for kind in W.layer_kind(self.cfg, l):
                k = table[kind]
                x = x + k["reference"](self, p[k["key"]], x, grouping)
        return self.norm(x, self.tree["ln_f"])

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final hidden rows [..., H] -> logits [..., V] (fp32)."""
        return self.mm(h, self.tree["lm_head"])

    def attention(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        b, t, H = x.shape
        h = self.norm(x, p["ln"])
        ha = self.a(h)
        q = torch.einsum("bth,hngd->btngd", ha, self.w(p["w_q"]))
        k = torch.einsum("bth,hnd->btnd", ha, self.w(p["w_k"]))
        v = torch.einsum("bth,hnd->btnd", ha, self.w(p["w_v"]))
        pos = torch.arange(t, device=x.device, dtype=torch.float32)
        q, k = _rope(q, pos, self.cfg.get("rope_theta", 10000.0)), \
            _rope(k, pos, self.cfg.get("rope_theta", 10000.0))
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty_like(q)
        kpos = torch.arange(t, device=x.device)
        for q0 in range(0, t, ATTN_Q_BLOCK):
            q1 = min(t, q0 + ATTN_Q_BLOCK)
            s = torch.einsum("bsngd,bknd->bngsk", q[:, q0:q1], k) * scale
            mask = kpos[None, :] <= torch.arange(q0, q1, device=x.device)[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            out[:, q0:q1] = torch.einsum("bngsk,bknd->bsngd",
                                         torch.softmax(s, dim=-1), v)
        return torch.einsum("btngd,ngdh->bth", self.a(out), self.w(p["w_o"]))

    def _gated(self, h, wg, wu, wd):
        return self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wu), wd)

    def ffn(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x, p["ln"])
        return self._gated(h, p["w_gate"], p["w_up"], p["w_down"])

    def moe(self, p: dict, x: torch.Tensor, grouping: str) -> torch.Tensor:
        cfg = self.cfg
        E, K = W.experts(cfg), W.top_k(cfg)
        b, t, H = x.shape
        h = self.norm(x, p["ln"])
        hg = h.transpose(0, 1) if grouping == "step" else h.reshape(1, b * t, H)
        G, n = hg.shape[:2]
        wr = self.w32(p["w_router"])
        hr = hg.to(torch.bfloat16).float() if self.precision == "fp8" else hg
        probs = torch.softmax(hr @ wr, dim=-1)                     # [G,n,E]
        top_v, top_i = torch.topk(probs, K, dim=-1)
        gates = top_v / top_v.sum(-1, keepdim=True)
        pick = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, top_i, True)
        gate = torch.zeros_like(probs).scatter_(-1, top_i, gates)
        # a pick's rank: how many earlier tokens of its dispatch chose the
        # same expert; ranks from the capacity on are dropped
        rank = torch.cumsum(pick.int(), dim=1) - pick.int()
        cap = max(1, int(math.ceil(n * K / E * self.cf)))
        keep = (pick & (rank < cap)).reshape(G * n, E)
        gate = gate.reshape(G * n, E)
        hf = hg.reshape(G * n, H)
        out = torch.zeros_like(hf)
        for e in range(E):
            idx = keep[:, e].nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
            y = self._gated(hf[idx], p["w_egate"][e], p["w_eup"][e],
                            p["w_edown"][e])
            out.index_add_(0, idx, y * gate[idx, e, None])
        if "shared" in p:
            sh = p["shared"]
            out = out + self._gated(hf, sh["w_gate"], sh["w_up"], sh["w_down"])
        out = out.reshape(G, n, H)
        return out.transpose(0, 1) if grouping == "step" \
            else out.reshape(b, t, H)

    def mamba(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, H = x.shape
        din = cfg["mamba_expand"] * H
        r, P = cfg["mamba_dt_rank"], cfg["mamba_d_state"]
        taps = cfg["mamba_d_conv"]
        h = self.norm(x, p["ln"])
        xz = self.mm(h, p["w_in"])
        xs, z = xz[..., :din], xz[..., din:]
        conv = self.w(p["conv"])
        xpad = torch.cat([xs.new_zeros(b, taps - 1, din), xs], dim=1)
        xc = sum(xpad[:, i:i + t] * conv[i] for i in range(taps))
        xc = F.silu(xc)
        xdb = self.mm(xc, p["w_xdb"])
        dt0, Bm, Cm = xdb[..., :r], xdb[..., r:r + P], xdb[..., r + P:]
        dt = F.softplus(self.mm(dt0, p["w_dt"]))                    # [b,t,din]
        A = -torch.exp(self.w32(p["A_log"]))                        # [din,P]
        y = torch.empty_like(xc)
        state = xc.new_zeros(b, din, P)
        hs = xc.new_empty(b, min(t, SCAN_CHUNK), din, P)
        for c0 in range(0, t, SCAN_CHUNK):
            c1 = min(t, c0 + SCAN_CHUNK)
            dA = torch.exp(dt[:, c0:c1, :, None] * A)
            dBx = (dt[:, c0:c1] * xc[:, c0:c1])[..., None] \
                * Bm[:, c0:c1, None, :]
            for i in range(c1 - c0):
                state = torch.addcmul(dBx[:, i], dA[:, i], state,
                                      out=hs[:, i])
            y[:, c0:c1] = torch.einsum("btdp,btp->btd", hs[:, :c1 - c0],
                                       Cm[:, c0:c1])
        y = (y + xc * self.w(p["D"])) * F.silu(z)
        return self.mm(y, p["w_out"])


def _row(stacked: dict, r: int) -> dict:
    return {k: _row(v, r) if isinstance(v, dict) else v[r]
            for k, v in stacked.items()}


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of x [B, T, ..., D] at positions
    pos [T]: the halves (x1, x2) rotated by pos * theta^(-i / (D/2))."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, device=x.device,
                                  dtype=torch.float32) / half)
    ang = pos[:, None] * inv                                       # [T, half]
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 3) + (half,)
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
