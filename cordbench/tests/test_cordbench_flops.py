"""The yardstick's counts against shapes worked by hand."""

import pytest

from cordbench import flops


def test_attention_pairs():
    assert flops.attention_pairs(4, 4) == 10                 # 1+2+3+4
    assert flops.attention_pairs(4, 4, True, 2) == 7         # 1+2+2+2
    assert flops.attention_pairs(3, 3, False) == 9


def test_flash_forward_and_backward_counts():
    ops, nbytes = flops.flash_fwd(1, 4, 2, 1, 8)
    assert ops == 4 * 8 * 2 * 10
    assert nbytes == (2 * 4 * 2 + 2 * 4 * 1) * 8 * 2
    ops, nbytes = flops.flash_fwd(1, 4, 2, 1, 8, lse=True)
    assert nbytes == (2 * 4 * 2 + 2 * 4 * 1) * 8 * 2 + 4 * 2 * 4
    ops, nbytes = flops.flash_bwd(2, 4, 2, 1, 8, window=2)
    assert ops == 10 * 8 * 2 * 2 * 7
    assert nbytes == (4 * 2 * 4 * 2 + 4 * 2 * 4 * 1) * 8 * 2 + 4 * 2 * 2 * 4


def test_scan_backward_counts():
    ops, nbytes = flops.scan_bwd(1, 2, 3, 4)
    assert ops == 20 * 1 * 2 * 3 * 4
    assert nbytes == 5 * 2 * 3 * 4 + 4 * (4 * 2 * 4 + 2 * 3 * 4 + 3 * 3 * 4)


def test_least_time_takes_the_larger_bound():
    assert flops.least_s(989e12, 0, flops.BF16_FLOPS) == pytest.approx(1.0)
    assert flops.least_s(0, 3.35e12, flops.BF16_FLOPS) == pytest.approx(1.0)


def _tiny(family):
    return {"family": family, "num_layers": 2, "d_model": 4, "d_ff": 8,
            "vocab_size": 10, "gated_mlp": True,
            "attention": {"num_heads": 2, "num_kv_heads": 1, "head_dim": 0,
                          "sliding_window": 0},
            "moe": {"num_experts": 4, "top_k": 2},
            "ssm": {"expand": 2, "state_size": 2, "dt_rank": 0}}


def test_model_flops_by_hand():
    from cordbench import cells
    moe, hybrid = cells.family("moe"), cells.family("hybrid")
    m = _tiny("moe")
    # attention: d*hd*(2H + 2KVH) = 4*2*6 = 48; router 16; 2 experts x
    # 3 x 4 x 8 = 192
    assert moe.matmul_params(m) == 2 * (48 + 16 + 192)
    # a 3-token prompt and 2 new tokens: 4 fed tokens, 2 logits, 10 pairs
    assert moe.request_flops(m, 3, 2) == \
        4 * 2 * 2 * 256 + 2 * 2 * 10 * 4 + 2 * 4 * 2 * 2 * 10
    hyb = _tiny("hybrid")
    # 48 + MLP 96 + mamba: in 4*16=64, x_proj 8*(1+4)=40, dt 8, out 32
    assert hybrid.matmul_params(hyb) == 2 * (48 + 96 + 144)
    tokens = 2 * 4
    mm = 2 * 288 + 10 * 4
    att = 2 * 4 * 2 * 2 * 2 * 10                   # 2 layers, batch 2
    scan = 6 * tokens * 8 * 2 * 2
    assert hybrid.train_step_flops(hyb, 2, 4) == \
        6 * mm * tokens + 3 * att + 3 * scan
    # serving counts the scan's forward in both layers: 4 fed tokens
    assert hybrid.request_flops(hyb, 3, 2) == \
        4 * 2 * 2 * 288 + 2 * 2 * 10 * 4 + 2 * 4 * 2 * 2 * 10 \
        + 2 * 6 * 4 * 8 * 2


@pytest.mark.parametrize("window", [0, 1, 3, 7, 40])
def test_causal_pairs_in_closed_form(window):
    for n in (1, 2, 5, 7, 8, 33):
        assert flops.causal_pairs(n, window) == \
            flops.attention_pairs(n, n, True, window)
