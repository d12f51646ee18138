"""The yardstick's operation and byte counts against hand counts at small
shapes."""

import pytest

from portbench import archs
from portbench import yardstick as ys


def test_attended_tokens():
    assert ys.attended(1, 5) == 1
    assert ys.attended(640, 5) == 640  # five full pages
    assert ys.attended(641, 5) == 4 * 128 + 1  # the sixth page begins
    assert ys.attended(3000, 5) == 4 * 128 + (3000 - 23 * 128)


def test_paged_call_hand_count():
    # two rows, 1 kv head, rep 2, hd 4, 2 pages read; rows of 3 and 200
    # tokens: 3 tokens and (128 + 72) = 200 tokens read
    nbytes, ops = ys.paged_call([3, 200], hkv=1, rep=2, hd=4, pages=2)
    tokens = 3 + 200
    want = (2 * 1 * 2 * 4 * 2 + 2 * 1 * 2 * 4 + 2 * 4
            + 2 * tokens * 4 * 2 + 2 * 1 * 2 * 4 * 4 + 2 * 1 * 2 * 4)
    assert nbytes == want
    assert ops == 4 * 2 * 4 * tokens


def test_decode_flops_hand_count():
    llama, rwkv6 = archs.get("llama"), archs.get("rwkv6")
    s = dict(arch="llama", layers=2, d=8, heads=2, kv_heads=1, head_dim=4,
             ffn=16, vocab=10)
    layer = 8 * 4 * (2 + 2) + 2 * 4 * 8 + 3 * 8 * 16
    assert llama.matmul_params(s) == 2 * layer + 10 * 8
    assert llama.decode_flops(s, 7) == \
        2 * (2 * layer + 80) + 4 * 2 * 4 * 7 * 2
    r = dict(arch="rwkv6", layers=1, d=8, heads=2, head_dim=4, ffn=16,
             vocab=10)
    assert rwkv6.decode_flops(r, 99) == 2 * (6 * 64 + 2 * 8 * 16 + 80) \
        + 4 * 8 * 4


def test_an_unknown_architecture_raises():
    with pytest.raises(ValueError, match="no architecture"):
        archs.get("mamba9")
    with pytest.raises(ValueError, match="no architecture"):
        archs.get("../llama")


def test_bound_picks_the_longer_term():
    b = ys.bound(3.35e12, 1.0)
    assert b["by"] == "bytes" and b["seconds"] == pytest.approx(1.0)
    b = ys.bound(1.0, 989e12 * 2)
    assert b["by"] == "operations" and b["seconds"] == pytest.approx(2.0)


def test_percentile_is_numpys_linear():
    assert ys.percentile([], 95) is None
    assert ys.percentile([1.0, 2.0], 50) == pytest.approx(1.5)
    assert ys.percentile(list(range(21)), 95) == pytest.approx(19.0)
