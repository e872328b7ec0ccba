"""The FLOP and byte arithmetic of `prefill_mfu` and `flash_roofline`
against hand counts, and the traffic schedule."""
import pytest

from chipbench import schedule, work
from chipbench.conftest import tiny_config
from chipbench.reference import mla_moe as R


def test_flash_work_hand_count():
    # 2 rows, 3 heads, 4 queries causal: 1+2+3+4 = 10 pairs a head
    assert work.flash_pairs(4, 4, True, 0) == 10 == work.causal_pairs(4)
    assert work.flash_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert work.flash_pairs(3, 5, False, 0) == 15
    flops, nbytes = work.flash_work(2, 3, 3, 4, 4, 24, 16, 2, True, 0)
    assert flops == 2 * (24 + 16) * 10 * 2 * 3
    # q and o (24 + 16 wide) a query row, k and v a key row, 2 bytes each
    assert nbytes == (2 * 3 * 4 * 40 + 2 * 3 * 4 * 40) * 2
    b = work.flash_bound_s((2, 3, 3, 4, 4, 24, 16, True, 0))
    assert b == max(flops / 989e12, nbytes / 3.35e12)


def test_prefill_flops_hand_count():
    c = tiny_config()
    b, s = 2, 8
    d, H, nope, dr, vd, r = 64, 4, 16, 8, 16, 32
    attn_w = d * H * (nope + dr) + d * (r + dr) + r * H * (nope + vd) \
        + H * vd * d
    moe_w = d * 8 + 2 * 3 * d * 32 + 3 * d * 32   # router, 2 of 8, shared
    linear = 2 * (attn_w + moe_w) * b * s * 2     # 2 layers
    attention = 2 * (nope + dr + vd) * (s * (s + 1) // 2) * H * b * 2
    head = 2 * d * 512 * b                        # last position only
    assert R.prefill_flops(c, b, s) == linear + attention + head
    calls = R.flash_calls(c, b, s)
    assert calls == [(b, H, H, s, s, nope + dr, vd, True, 0)] * 2


def test_dsv2lite_flops_a_token():
    """About 4.5 GFLOP a token of linear work at DeepSeek-V2-Lite's widths
    (2.25B weights a token passes through, the head left out)."""
    import json
    from pathlib import Path

    c = json.loads((Path(__file__).parent / "configs" / "dsv2lite.json")
                   .read_text())
    per = (R.prefill_flops(c, 1, 1) - 2 * 2048 * 102400 - 2 * 320 * 16 * 27)
    assert 4.4e9 < per < 4.6e9


TRAFFIC = {"slots": 4, "gen_tokens": 1,
           "lengths": [[256, 3], [512, 3], [1024, 2], [2048, 1]],
           "compare_cycles": 2}


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11, 2**40 + 3])
def test_schedule_same_multiset_any_seed(seed):
    order = schedule.cycle(TRAFFIC, seed)
    assert sorted(order) == sorted(schedule.cycle(TRAFFIC, 12345))
    assert sorted(order) == [256] * 3 + [512] * 3 + [1024] * 2 + [2048]
    assert schedule.compared(TRAFFIC) == 18          # two whole cycles
    assert schedule.cycle(TRAFFIC, seed) == order      # the seed fixes it


def test_schedule_order_and_ids_follow_the_seed():
    orders = {tuple(schedule.cycle(TRAFFIC, s)) for s in range(8)}
    assert len(orders) > 4
    a = schedule.Prompts(5, 1000, 4).batch(16)
    b = schedule.Prompts(5, 1000, 4).batch(16)
    c = schedule.Prompts(6, 1000, 4).batch(16)
    assert all((x == y).all() for x, y in zip(a, b))
    assert any((x != y).any() for x, y in zip(a, c))
    assert all(0 <= x.min() and x.max() < 1000 for x in a)
