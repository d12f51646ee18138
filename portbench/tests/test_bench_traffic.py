"""The traffic generator repeats exactly for a seed, every seed deals the
same sizes in the same order, and the seed draws the prompts' tokens."""

import numpy as np

from portbench import spec
from portbench.traffic import Traffic, deck

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)


def _take(mix, seed, n=40, deck_size=16):
    t = Traffic(mix, 64000, seed, deck_size)
    return [t.take() for _ in range(n)]


def test_same_seed_same_requests():
    mix = spec.load_mix("decode-long")
    for seed in SEEDS:
        a, b = _take(mix, seed), _take(mix, seed)
        for x, y in zip(a, b):
            assert x.max_new_tokens == y.max_new_tokens
            np.testing.assert_array_equal(x.prompt, y.prompt)


def test_every_seed_deals_the_same_sizes():
    mix = spec.load_mix("decode-long")
    cycles = []
    for seed in SEEDS:
        reqs = _take(mix, seed, n=32)
        for c in (reqs[:16], reqs[16:]):
            cycles.append((sorted(len(r.prompt) for r in c),
                           sorted(r.max_new_tokens for r in c)))
    assert all(c == cycles[0] for c in cycles)
    orders = {tuple((len(r.prompt), r.max_new_tokens)
                    for r in _take(mix, s, n=40)) for s in SEEDS}
    assert len(orders) == 1
    firsts = {tuple(_take(mix, s, n=1)[0].prompt) for s in SEEDS}
    assert len(firsts) == len(SEEDS)


def test_sizes_within_the_mix():
    for name in ("decode-long", "chat-short"):
        mix = spec.load_mix(name)
        for r in _take(mix, 5, n=64, deck_size=8):
            assert mix["prompt_len"]["lo"] <= len(r.prompt) \
                <= mix["prompt_len"]["hi"]
            assert mix["output_len"]["lo"] <= r.max_new_tokens \
                <= mix["output_len"]["hi"]
            assert len(r.prompt) + r.max_new_tokens <= mix["seq_len"]
            assert r.prompt.dtype == np.int32 and r.prompt.max() < 64000


def test_deck_quantiles():
    d = deck({"dist": "loguniform", "lo": 16, "hi": 64}, 2)
    assert d == [round(16 * 4 ** 0.25), round(16 * 4 ** 0.75)]
    assert deck({"dist": "fixed", "value": 5}, 3) == [5, 5, 5]
