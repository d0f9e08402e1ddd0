"""The Mamba mixer's selective scan (``kernels/selective_scan.py``) on the
CPU: the entry computes the plain version there, which is within 1e-5
relative of the float64 step-by-step oracle ``kernels.ref.ref_selective_scan``
(``tests/test_torch_mamba.py`` holds it against the JAX package); the
entry's checks refuse what the kernel cannot take and accept the layer's
strided views; ``split`` cuts the sequence as its rule says; and
``mamba_layer`` trains through the plain version by its runtime's choice and
takes the plain path on CPU, meta and fake tensors, counting its path while
tracing is on.  The kernel itself runs only on the card (``chip_smoke.py``,
kernels phase); the entry on a mesh in ``tests/test_torch_multirank.py``."""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import layers as L
from repro_torch.models.common import Initializer, RuntimeCfg
from repro_torch.obs import metrics, spans

SPEC = get("jamba-v0.1-52b").smoke
DIN = SPEC.ssm.expand * SPEC.d_model
P = SPEC.ssm.d_state
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _clean_obs():
    spans.disable()
    metrics.reset()
    yield
    spans.disable()
    spans.take_events()
    metrics.reset()


def _inputs(seed, b, s, d=DIN, p=P, dtype=F32, h0=True, dtr=5):
    """dtt = softplus(N(0, 1)), xc, and B and C as the layer's strided views
    of one ``xdb`` [B, S, dtr + 2P]; A_log = log U(1, 16); h0 ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    dtt = torch.nn.functional.softplus(torch.randn(b, s, d, generator=g))
    xc = torch.randn(b, s, d, generator=g).to(dtype)
    xdb = torch.randn(b, s, dtr + 2 * p, generator=g).to(dtype)
    a_log = torch.log(1 + 15 * torch.rand(d, p, generator=g))
    state = torch.randn(b, d, p, generator=g) if h0 else None
    return dtt, xc, xdb[..., dtr:dtr + p], xdb[..., dtr + p:], a_log, state


@pytest.mark.parametrize("s,dtype,h0", [(20, F32, True), (300, F32, True),
                                        (512, BF16, False), (1, BF16, True)],
                         ids=["20", "300", "512-bf16-zero", "1-bf16"])
def test_entry_on_the_cpu_is_the_plain_version(s, dtype, h0):
    """On the CPU the entry computes ``selective_scan_plain``, bit for bit:
    no launch, y in x's dtype, the state only on request."""
    args = _inputs(s, 2, s, dtype=dtype, h0=h0)
    want_y, want_h = SS.selective_scan_plain(*args)
    before = SS.launches
    y, h = ops.selective_scan(*args)
    _, none = ops.selective_scan(*args, state=False)
    assert y.dtype == dtype and torch.equal(y, want_y)
    assert torch.equal(h, want_h) and none is None
    assert SS.launches == before


@pytest.mark.parametrize("s", [1, 37, 300, 600])
def test_plain_vs_the_float64_oracle(s):
    """The chunked log-depth scan in fp32 against ``ref_ssm`` run step by
    step in float64 and the y-contraction, within 1e-5 relative."""
    args = _inputs(100 + s, 2, s, d=24, p=16)
    got_y, got_h = SS.selective_scan_plain(*args)
    want_y, want_h = ref.ref_selective_scan(*args)
    assert want_y.dtype == want_h.dtype == torch.float64
    for got, want in ((got_y, want_y), (got_h, want_h)):
        want = want.numpy()
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_ref_selective_scan_is_ref_ssm_and_the_contraction():
    dtt, xc, Bt, Ct, a_log, h0 = (t.double() for t in _inputs(3, 1, 9))
    dA = torch.exp(dtt[..., None] * -torch.exp(a_log))
    dBx = (dtt * xc)[..., None] * Bt[:, :, None, :]
    hs, h = ref.ref_ssm(dA, dBx, h0)
    y, h_last = ref.ref_selective_scan(dtt, xc, Bt, Ct, a_log, h0)
    assert torch.equal(h_last, h)
    assert torch.allclose(y, (hs * Ct[:, :, None, :]).sum(-1), rtol=1e-14)
    y0, _ = ref.ref_selective_scan(dtt, xc, Bt, Ct, a_log)
    hs0, _ = ref.ref_ssm(dA, dBx, torch.zeros_like(h0))
    assert torch.allclose(y0, (hs0 * Ct[:, :, None, :]).sum(-1), rtol=1e-14)


def _bad(case):
    """Inputs of one call with one thing wrong."""
    dtt, xc, Bt, Ct, a_log, h0 = _inputs(0, 2, 8, d=6, p=4)
    if case == "dtt-2d":
        dtt = dtt[0]
    elif case == "dtt-bf16":
        dtt = dtt.to(BF16)
    elif case == "xc-shape":
        xc = xc[:, :7]
    elif case == "xc-int":
        xc = xc.to(torch.int32)
    elif case == "xc-float64":
        xc, Bt, Ct = xc.double(), Bt.double(), Ct.double()
    elif case == "bc-dtype":
        Bt = Bt.to(BF16)
    elif case == "bt-states":
        Bt = torch.zeros(2, 8, 5)
    elif case == "ct-seq":
        Ct = Ct[:, :4]
    elif case == "a_log-shape":
        a_log = a_log[:5]
    elif case == "a_log-bf16":
        a_log = a_log.to(BF16)
    elif case == "h0-shape":
        h0 = h0[:1]
    elif case == "h0-bf16":
        h0 = h0.to(BF16)
    elif case == "meta-device":
        h0 = h0.to("meta")
    return dtt, xc, Bt, Ct, a_log, h0


BAD = {"dtt-2d": ValueError, "dtt-bf16": TypeError, "xc-shape": ValueError,
       "xc-int": TypeError, "xc-float64": TypeError, "bc-dtype": TypeError,
       "bt-states": ValueError, "ct-seq": ValueError,
       "a_log-shape": ValueError, "a_log-bf16": TypeError,
       "h0-shape": ValueError, "h0-bf16": TypeError,
       "meta-device": ValueError}


@pytest.mark.parametrize("case", list(BAD))
def test_entry_refuses(case):
    """Shapes, dtypes and devices are checked on every device, before any
    work."""
    with pytest.raises(BAD[case]):
        ops.selective_scan(*_bad(case))


def _kernel_bad(case):
    """One call the kernel cannot take (the plain version can)."""
    dtt, xc, Bt, Ct, a_log, h0 = _inputs(0, 2, 8, d=6, p=4)
    if case == "xc-strided-channels":
        xc = torch.zeros(2, 6, 8).transpose(1, 2)
    elif case == "bt-every-other":
        Bt = torch.zeros(2, 8, 8)[..., ::2]
    elif case == "h0-transposed":
        h0 = torch.zeros(2, 4, 6).transpose(1, 2)
    elif case == "a_log-transposed":
        a_log = torch.zeros(4, 6).T
    elif case == "32-states":
        Bt, Ct = torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)
        a_log, h0 = torch.zeros(6, 32), None
    return dtt, xc, Bt, Ct, a_log, h0


KERNEL_BAD = ["xc-strided-channels", "bt-every-other",
              "h0-transposed", "a_log-transposed", "32-states"]


@pytest.mark.parametrize("case", KERNEL_BAD)
def test_kernel_checks_refuse(case):
    """Beyond the entry's checks: the kernel reads by strides with a
    contiguous last dim, reads A_log and the state whole and holds at most
    16 states a channel.  The plain version takes all of it."""
    args = _kernel_bad(case)
    SS._check(*args)
    with pytest.raises(ValueError):
        SS._check_kernel(*args)
    SS.selective_scan_plain(*args)


def test_kernel_checks_accept_the_served_layouts():
    """The layer's layouts: contiguous dtt and xc, B and C as strided views
    of ``xdb`` [B, S, dt_rank + 2P] in bf16, the decode state a
    row of the engine's stacked cache [layers, B, Din, P]."""
    dtt, xc, Bt, Ct, a_log, _ = _inputs(1, 2, 64, d=256, p=16, dtype=BF16,
                                        dtr=256)
    cache = torch.zeros(3, 2, 256, 16)
    assert Bt.stride() == (64 * 288, 288, 1) and not Bt.is_contiguous()
    for h0 in (cache[1], None):
        SS._check(dtt, xc, Bt, Ct, a_log, h0)
        SS._check_kernel(dtt, xc, Bt, Ct, a_log, h0)


@pytest.mark.parametrize("b,s,want", [(1, 8192, (8, 1024)),
                                      (2, 4096, (4, 1024)),
                                      (4, 2048, (1, 2048)),
                                      (2, 2048, (4, 512)),
                                      (8, 1024, (1, 1024)), (8, 1, (1, 1)),
                                      (1, 100, (1, 100)), (1, 128, (2, 64)),
                                      (1, 63, (1, 63)),
                                      (1, 1000, (8, 125)),
                                      (1, 700, (8, 88))])
def test_split_at_the_served_shapes(b, s, want):
    """Din 8192 on 132 SMs: the prefill cell's four batch shapes, the
    serve check's [2, 2048] and the decode step; short prompts keep chunks
    of at least 64 steps; a length that does not divide leaves the last
    chunk shorter."""
    assert SS.split(b, s, 8192, 132) == want


@pytest.mark.parametrize("b,s,d,sms", [(1, 1, 1, 1), (3, 1001, 96, 132),
                                       (1, 65536, 8192, 132),
                                       (16, 4096, 8192, 132),
                                       (1, 5, 8192, 132), (7, 333, 40, 8)])
def test_split_covers_the_sequence(b, s, d, sms):
    n, length = SS.split(b, s, d, sms)
    assert n >= 1 and length >= 1
    assert (n - 1) * length < s <= n * length          # no empty chunk
    assert n == 1 or length >= min(SS.MIN_CHUNK, s)


def _mamba_params(dtype="float32", device="cpu"):
    ini = Initializer(torch.Generator().manual_seed(0), dtype, "cpu")
    return {k: v.to(device) for k, v in L.init_mamba(ini, SPEC, "m_").items()}


def _counts():
    return {k: v for k, v in metrics.REGISTRY.collect()["counters"].items()
            if k.startswith("mamba.") and v}


def test_mamba_layer_trains_through_the_plain_path():
    """Training chooses the plain version (``attention_impl="chunked"``),
    which autograd follows: gradients reach A_log.  Through the kernel's
    entry (``"cuda"``) the same call raises, naming the kernel."""
    p = {k: v.requires_grad_(True) for k, v in _mamba_params().items()}
    x = torch.randn(2, 12, SPEC.d_model, generator=torch.Generator()
                    .manual_seed(1))
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32",
                    attention_impl="chunked")
    with spans.profiled():
        out, _ = L.mamba_layer(p, x, SPEC, rt)
    out.sum().backward()
    assert p["A_log"].grad is not None and torch.isfinite(p["A_log"].grad).all()
    assert _counts() == {"mamba.ssm_plain": 1}
    with pytest.raises(RuntimeError, match="selective_scan"):
        L.mamba_layer(p, x, SPEC, dataclasses.replace(rt,
                                                      attention_impl="cuda"))


@pytest.mark.parametrize("impl", ["cuda", "chunked"])
@pytest.mark.parametrize("where", ["cpu", "meta", "fake"])
def test_mamba_layer_takes_the_plain_path_off_the_card(where, impl):
    """CPU, meta and fake tensors (the dry run's) never reach the kernel,
    through its entry or not: no launch, one plain call counted a layer
    call while tracing is on, and nothing counted while it is off."""
    rt = RuntimeCfg(param_dtype="float32", compute_dtype="float32",
                    attention_impl=impl)
    before = SS.launches

    def run():
        p = _mamba_params(device="meta" if where == "meta" else "cpu")
        x = torch.randn(2, 5, SPEC.d_model, device=p["w_in"].device)
        cache = {"conv": torch.zeros(2, 3, DIN, device=x.device),
                 "ssm": torch.zeros(2, DIN, P, device=x.device)}
        if where == "fake":
            with FakeTensorMode() as mode:
                p = {k: mode.from_tensor(v) for k, v in p.items()}
                x = mode.from_tensor(x)
                cache = {k: mode.from_tensor(v) for k, v in cache.items()}
                return L.mamba_layer(p, x, SPEC, rt, cache=cache)
        return L.mamba_layer(p, x, SPEC, rt, cache=cache)

    out, cache = run()                                  # tracing off
    assert out.shape == (2, 5, SPEC.d_model) and cache["ssm"].shape == (
        2, DIN, P)
    assert _counts() == {}
    with spans.profiled():
        run()
        run()
    assert _counts() == {"mamba.ssm_plain": 2}
    assert SS.launches == before
