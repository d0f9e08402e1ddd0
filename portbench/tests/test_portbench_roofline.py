"""The yardstick's counts against numbers worked out by hand."""
import pytest

from portbench import manifest, roofline
from portbench import weights as W
from portbench.tests.helpers import deepseek_v2

BENCH = manifest.Bench(manifest.HERE.parent)


def test_flash_bound_of_a_decode_call():
    # 32 rows of 16 heads x 128, 300 keys visible of a 4096-row cache:
    # bytes 2 x (32*16*256 + 32*300*16*256) = 78 905 344 -> bytes-bound
    call = dict(q=(32, 1, 16, 1, 128), k=(32, 4096, 16, 128),
                v=(32, 4096, 16, 128), esize=2, causal=True, window=None,
                q_offset=299)
    assert roofline.flash_bound_s(call) == pytest.approx(78_905_344 / 3.35e12)


def test_flash_bound_of_a_prefill_call():
    # causal 1024 x 1024, 8 kv heads x 4 query heads x 128: 524 800 pairs,
    # ops 2 * 32 * 256 * 524 800 = 8 598 323 200 -> operations-bound
    call = dict(q=(1, 1024, 8, 4, 128), k=(1, 1024, 8, 128),
                v=(1, 1024, 8, 128), esize=2, causal=True, window=None,
                q_offset=0)
    assert roofline.flash_bound_s(call) == pytest.approx(8_598_323_200 / 989e12)


@pytest.mark.parametrize("name, params", [
    # lm_head 209 715 200 + attention 28 x 16 777 216 + dense layer
    # 67 239 936 + 27 MoE layers x (router 131 072 + 8 x 3 x 2048 x 1408)
    ("deepseek-moe-16b", 2_618_818_560),
    # lm_head 268 435 456 + attention 41 943 040 + 7 Mamba x 105 119 744 +
    # 4 dense FFN x 176 160 768 + 4 MoE x (65 536 + 2 x 176 160 768)
    ("jamba-v0.1-52b.d8", 3_160_408_064),
])
def test_product_parameters_of_a_token(name, params):
    assert roofline.product_params_per_token(BENCH.config(name)) == params


def test_model_flops_of_one_token():
    cfg = BENCH.config("deepseek-moe-16b")
    # a token attending 100 positions: 2 x params + 4 x 16 x 128 x 28 x 100
    assert roofline.model_flops(cfg, 1, 100) == \
        2 * 2_618_818_560 + 4 * 16 * 128 * 28 * 100


def test_mla_counts_of_deepseek_v2():
    cfg = deepseek_v2()
    mla = W.kinds(cfg)["mla"]
    # H q_lora 7 864 320 + q_lora N (nope + rope) 37 748 736 + H kv_lora
    # 2 621 440 + H rope 327 680 + kv_lora N (nope + v) 16 777 216 +
    # N v H 83 886 080
    assert mla["params_per_token"](cfg) == 149_225_472
    # 2 N (nope + rope) 49 152 + 2 N v 32 768
    assert mla["flops_per_position"](cfg) == 81_920
    # lm_head 524 288 000 + 60 MLA layers + the dense layer 188 743 680 +
    # 59 MoE layers x (router 819 200 + 8 x 3 x 5120 x 1536): the "21B
    # activated" of arXiv:2405.04434 less the embedding
    assert roofline.product_params_per_token(cfg) == \
        524_288_000 + 60 * 149_225_472 + 188_743_680 + 59 * 189_562_880
    assert roofline.model_flops(cfg, 1, 100) == \
        2 * 20_850_769_920 + 60 * 81_920 * 100
