"""The traffic generator: requests of a serving mix, from the seed.

Lengths are stratified: a *deck* holds one length at each of ``deck``
evenly spaced quantiles of the mix's distribution, and every cycle of
``deck`` requests deals the deck shuffled (prompt and output decks apart,
each cycle another shuffle). The shuffles are the mix's, the same for
every seed: the seed draws the prompts' tokens (and the weights), never
the sizes or their order, so every seed sends the same work. Where the
order followed the seed, which requests landed in the window and which
admissions met in one step changed from seed to seed, and the tails
spread by a third between seeds where two runs of one seed agreed within
a few percent (``yi-6b.chat``, 6 seeds). Prompt tokens are uniform over
the vocabulary, drawn from the seed and the request's index.

A length distribution is ``{"dist": "loguniform", "lo": a, "hi": b}``
(``lo * (hi / lo) ** u``, rounded) or ``{"dist": "fixed", "value": n}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: seeds may exceed 64 bits' worth of nothing: numpy takes any
#: non-negative integer, and a negative one is folded in
_SEED_MOD = 2 ** 64


def seed_key(seed: int) -> int:
    return int(seed) % _SEED_MOD


def quantile(dist: dict, u: float) -> int:
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    if kind == "loguniform":
        lo, hi = float(dist["lo"]), float(dist["hi"])
        return int(round(lo * (hi / lo) ** u))
    raise ValueError(f"no length distribution {kind!r}")


def deck(dist: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n``."""
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int


class Traffic:
    """The mix's request sequence for one seed; ``take()`` deals the next
    request. Two instances of one seed deal the same sequence."""

    def __init__(self, mix: dict, vocab: int, seed: int, deck_size: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.seed = seed_key(seed)
        self.deck_size = int(deck_size)
        self._prompt_deck = deck(mix["prompt_len"], self.deck_size)
        self._output_deck = deck(mix["output_len"], self.deck_size)
        self.dealt = 0

    def _order(self, which: int, cycle: int) -> np.ndarray:
        rng = np.random.default_rng([which, cycle])
        return rng.permutation(self.deck_size)

    def sizes(self, index: int) -> tuple[int, int]:
        cycle, pos = divmod(index, self.deck_size)
        p = self._prompt_deck[self._order(0, cycle)[pos]]
        o = self._output_deck[self._order(1, cycle)[pos]]
        return p, o

    def request(self, index: int) -> Request:
        p, o = self.sizes(index)
        rng = np.random.default_rng([self.seed, 2, index])
        prompt = rng.integers(0, self.vocab, size=p, dtype=np.int64)
        return Request(index, prompt.astype(np.int32), o)

    def take(self) -> Request:
        req = self.request(self.dealt)
        self.dealt += 1
        return req
