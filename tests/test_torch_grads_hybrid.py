"""The port's loss and every gradient against ``jax.value_and_grad(repro.
models.lm.loss_fn)`` on the CPU, for the families beyond the attention
decoders: deepseek-moe (MoE with a dense first layer), jamba (Mamba +
attention + MoE, period 8), whisper (encoder and cross-attention, frames
from the batch) and rwkv6 (the chunk loop ``_wkv_chunk``, chunks of 32,
the -80/C floor).

Inputs, runtimes and tolerances as in ``test_torch_grads_dense.py``: fp32,
``"chunked"`` attention with ``attn_chunk=16``, a [2, 32] batch,
``loss_chunk`` 8; the loss within 1e-5 relative, every gradient leaf
within 1e-4 * max|reference leaf| + 1e-6 (jamba's worst leaf is near 8e-6,
rwkv6's near 2e-5 of its max)."""
import pytest

from torch_port_helpers import check_loss_and_grads, check_remat_equal

FAMILIES = ("deepseek-moe-16b", "jamba-v0.1-52b", "whisper-medium",
            "rwkv6-7b")
CASES = [(name, 8) for name in FAMILIES]


@pytest.mark.parametrize("name,loss_chunk", CASES)
def test_loss_and_grads_match_reference(name, loss_chunk):
    check_loss_and_grads(name, loss_chunk)


def test_remat_gives_equal_gradients():
    """The Mamba hybrid: remat around each repeat of the period of 8."""
    check_remat_equal("jamba-v0.1-52b")
