"""The port's loss and every gradient against ``jax.value_and_grad(repro.
models.lm.loss_fn)`` on the CPU, for the attention families' smoke specs:
qwen3, granite's MQA, minitron's gelu FFN, gemma2's alternating windows and
softcaps (fp32 logits), internvl2's vision prefix (logits cut to the
labels) and deepseek-v2's MLA (q/k 24, v 16; MoE after a dense first
layer).

Both packages start from the same numpy parameters (the reference's init,
carried across by ``models/convert.py``) and the same numpy batch [2, 32];
fp32, ``attention_impl="chunked"`` with ``attn_chunk=16`` (queries in two
blocks, keys in two chunks), ``loss_chunk`` 8 (four chunks) and 0.  The
reference is jitted.  The loss within 1e-5 relative; every gradient leaf
within 1e-4 * max|reference leaf| + 1e-6 (the same arithmetic in another
order of sums; the worst leaf seen is near 2e-6 of its max).  ``remat``
none / full / dots give the same gradients (1e-6 of the leaf's max: the
recomputation repeats the same operations)."""
import pytest

from torch_port_helpers import (check_loss_and_grads, check_remat_equal,
                                train_runtimes)

FAMILIES = ("qwen3-14b", "granite-34b", "minitron-8b", "gemma2-27b",
            "internvl2-26b", "deepseek-v2-236b")
# loss_chunk off for the logits that differ in kind: gemma2's fp32
# softcapped logits, internvl2's cut to the labels (a plain decoder's
# unchunked loss: test_torch_train.py's train steps)
CASES = [(name, 8) for name in FAMILIES] + [
    ("gemma2-27b", 0), ("internvl2-26b", 0)]


@pytest.mark.parametrize("name,loss_chunk", CASES)
def test_loss_and_grads_match_reference(name, loss_chunk):
    check_loss_and_grads(name, loss_chunk)


def test_remat_gives_equal_gradients():
    check_remat_equal("qwen3-14b")


def test_remat_unknown_raises():
    from repro_torch.models import lm
    _, trt = train_runtimes(0, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        lm._remat(lambda x: x, trt)
