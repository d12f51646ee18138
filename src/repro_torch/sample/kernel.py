"""Greedy token selection and the stacked wave-side sampler state
(counterpart of the greedy part of the JAX package's ``sample/kernel.py``).

:class:`SamplerRows` carries per-slot scalars as tensors (data, not
Python), stacked like the KV buffer and scattered at admission: seed, RNG
position counter, temperature, top-k, top-p, greedy flag, the stop-token
set and the last emitted token's logprob. This slice fills them for
greedy requests only; building rows for a stochastic
:class:`~repro_torch.sample.spec.SamplerSpec` raises
``NotImplementedError`` (threefry-exact sampling is a later slice).

All selection math is f32; ties break toward the lowest index
(``torch.argmax`` returns the first maximal index).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sample.spec import GREEDY

#: per-slot stop-token table width (``ServeSession.submit`` rejects more)
MAX_STOP_TOKENS = 8
NO_STOP = -1  # padding value; emitted tokens are always >= 0


@dataclasses.dataclass
class SamplerRows:
    """Stacked per-slot sampler state (each leaf ``(slots,)``; ``stop`` is
    ``(slots, MAX_STOP_TOKENS)``).

    ``pos`` is the counter of the NEXT token: it advances by one per wave
    for every slot, in lockstep with the emitted token, unless the stop
    guard holds it. ``logp`` is the raw log-probability of the token each
    slot emitted last wave (output, not config).
    """

    seed: torch.Tensor  # (S,) int64 holding uint32 seeds
    pos: torch.Tensor  # (S,) int32
    temperature: torch.Tensor  # (S,) f32
    top_k: torch.Tensor  # (S,) int32
    top_p: torch.Tensor  # (S,) f32
    greedy: torch.Tensor  # (S,) bool
    stop: torch.Tensor  # (S, MAX_STOP_TOKENS) int32, NO_STOP-padded
    logp: torch.Tensor  # (S,) f32

    @classmethod
    def init(cls, n: int, device=None) -> "SamplerRows":
        """All-greedy defaults for a fresh wave buffer."""
        return cls.from_specs([None] * n, [0] * n, device=device)

    @classmethod
    def from_specs(cls, specs, positions, stops=None,
                   device=None) -> "SamplerRows":
        """Rows for a list of ``SamplerSpec | None`` (None = greedy)."""
        specs = [s if s is not None else GREEDY for s in specs]
        if any(not s.is_greedy for s in specs):
            raise NotImplementedError(
                "stochastic sampling (temperature > 0) is not ported yet: "
                "the port serves greedy requests only")
        stop = np.full((len(specs), MAX_STOP_TOKENS), NO_STOP, np.int32)
        for i, toks in enumerate(stops or []):
            for j, tok in enumerate(toks or ()):
                stop[i, j] = int(tok)

        def t(values, dtype):
            return torch.as_tensor(np.asarray(values), dtype=dtype,
                                   device=device)
        return cls(
            seed=t([s.seed for s in specs], torch.int64),
            pos=t(positions, torch.int32),
            temperature=t([s.temperature for s in specs], torch.float32),
            top_k=t([s.top_k for s in specs], torch.int32),
            top_p=t([s.top_p for s in specs], torch.float32),
            greedy=t([s.is_greedy for s in specs], torch.bool),
            stop=t(stop, torch.int32),
            logp=torch.zeros((len(specs),), dtype=torch.float32,
                             device=device),
        )

    def clone(self) -> "SamplerRows":
        return SamplerRows(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})

    def advance_(self, hold=None) -> "SamplerRows":
        """Counters after one wave, in place; ``hold`` (S,) bool masks
        slots whose counter must not move (the stop guard freezes token
        and counter together)."""
        if hold is None:
            self.pos.add_(1)
        else:
            self.pos.add_(torch.where(hold, 0, 1).to(self.pos.dtype))
        return self

    def advance(self, hold=None) -> "SamplerRows":
        """:meth:`advance_` on a copy."""
        return self.clone().advance_(hold)

    def scatter_(self, slots, rows: "SamplerRows") -> "SamplerRows":
        """Write ``rows`` at ``slots``, in place (admission)."""
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.pos.device)
        for f in dataclasses.fields(self):
            big = getattr(self, f.name)
            big[idx] = getattr(rows, f.name).to(big.device)
        return self

    def scatter(self, slots, rows: "SamplerRows") -> "SamplerRows":
        """:meth:`scatter_` on a copy."""
        return self.clone().scatter_(slots, rows)


def greedy_select(logits: torch.Tensor) -> torch.Tensor:
    """(S, vocab) logits -> (S,) int32 first-max argmax per slot."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Log-probability of ``tok`` under each slot's RAW distribution.

    logits (S, vocab), tok (S,) -> (S,) f32, as the reference's stable
    log-softmax gather: ``vec[tok] - (m + log(sum(exp(vec - m))))``.
    """
    vec = logits.float()
    m = torch.amax(vec, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(vec - m[:, None]), dim=-1))
    return vec.gather(-1, tok.long()[:, None])[:, 0] - lse
