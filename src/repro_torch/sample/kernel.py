"""Per-slot token selection and the stacked wave-side sampler state
(counterpart of the JAX package's ``sample/kernel.py``).

The reference vmaps one per-slot kernel, ``sample_from_logits(logits,
row)``; here every function takes the whole wave at once, ``(slots,
vocab)`` logits and a :class:`SamplerRows`, and each slot's result depends
on that slot's own row only. Greedy rows reduce to first-max argmax;
stochastic rows draw by Gumbel-max over the temperature / top-k / top-p
filtered scores, keyed by :func:`repro_torch.sample.rng.token_key` on the
row's ``(seed, pos)``. The keys, bits and uniforms are bitwise the
reference's; the Gumbel noise and the top-p prefix sums may differ from
XLA's by an ulp (torch's ``log`` and ``cumsum``), so a sampled token can
differ only where two perturbed scores are that close.

:class:`SamplerRows` carries per-slot scalars as tensors (data, not
Python), stacked like the KV buffer and scattered at admission: seed, RNG
position counter, temperature, top-k, top-p, greedy flag, the stop-token
set and the last emitted token's logprob, so greedy and sampled requests
share one captured wave.

All selection math is f32; ties break toward the lowest index (stable
sorts, ``torch.argmax`` returns the first maximal index). Nothing syncs
with the host, so the selection can sit inside a captured CUDA graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sample import rng
from repro_torch.sample.spec import GREEDY, SamplerSpec

NEG = -1e30  # the reference's mask value for filtered scores
_MIN_TEMP = 1e-6  # guards the T -> 0 division; T == 0 takes the greedy branch

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

    def block(self, slots: slice) -> "SamplerRows":
        """The rows of a block of slots (views: in-place writes land in
        these rows)."""
        return SamplerRows(**{f.name: getattr(self, f.name)[slots]
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


def _mask_top_k(scores: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep each row's ``k`` highest scores (ties at the threshold all
    kept; the later argmax breaks them toward low indices). scores
    (S, V) f32, k (S,) int; ``k`` 0 or >= V keeps the row as it is."""
    v = scores.shape[-1]
    kk = torch.clamp(k.long(), 1, v)
    thresh = torch.sort(scores, dim=-1).values.gather(-1, (v - kk)[:, None])
    drop = ((k > 0) & (k < v))[:, None] & (scores < thresh)
    return torch.where(drop, NEG, scores)


def _mask_top_p(scores: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus truncation per row: keep the minimal descending-probability
    prefix reaching mass ``p`` (a token enters while the mass *before* it
    is < p, so the most probable token always survives). ``p`` (S,) f32;
    1.0 keeps the row as it is."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / torch.sum(e, dim=-1, keepdim=True)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sorted_probs = probs.gather(-1, order)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    drop = (p < 1.0)[:, None] & ~keep
    return torch.where(drop, NEG, scores)


def sample_from_logits(logits: torch.Tensor,
                       rows: SamplerRows) -> torch.Tensor:
    """(S, vocab) (or (S, 1, vocab)) logits -> (S,) int32 tokens under
    each slot's row: first-max argmax for greedy rows, Gumbel-max over
    the filtered scores with the key ``(seed, pos)`` for the others."""
    vec = logits.reshape(logits.shape[0], logits.shape[-1]).float()
    greedy_tok = torch.argmax(vec, dim=-1)
    scaled = vec / torch.clamp_min(rows.temperature.float(),
                                   _MIN_TEMP)[:, None]
    scaled = _mask_top_k(scaled, rows.top_k)
    scaled = _mask_top_p(scaled, rows.top_p)
    noise = rng.gumbel(rng.token_key(rows.seed, rows.pos), vec.shape[-1])
    sampled_tok = torch.argmax(scaled + noise, dim=-1)
    return torch.where(rows.greedy, greedy_tok, sampled_tok).to(torch.int32)


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Log-probability of ``tok`` under each slot's RAW distribution.

    logits (S, vocab), tok (S,) -> (S,) f32, as the reference's stable
    log-softmax gather: ``vec[tok] - (m + log(sum(exp(vec - m))))``.
    """
    vec = logits.float()
    m = torch.amax(vec, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(vec - m[:, None]), dim=-1))
    return vec.gather(-1, tok.long()[:, None])[:, 0] - lse


def token_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """:func:`token_logprob` over ``(slots, 1, vocab)`` logits and
    ``(slots, ...)`` tokens -> ``(slots,)`` f32."""
    n = logits.shape[0]
    return token_logprob(logits.reshape(n, logits.shape[-1]),
                         toks.reshape(n))


def select_tokens(logits: torch.Tensor, rows: SamplerRows):
    """Stacked selection: ``(slots, 1, vocab)`` logits + rows ->
    ``((slots, 1, 1) int32 tokens, advanced rows)``, the advanced rows
    carrying each token's raw logprob in ``logp``; ``rows`` is left as it
    was."""
    n = logits.shape[0]
    toks = sample_from_logits(logits, rows)
    advanced = rows.advance()
    advanced.logp = token_logprobs(logits, toks)
    return toks.reshape(n, 1, 1), advanced


def sample_token(logits, spec: SamplerSpec | None, position: int = 0) -> int:
    """One draw through the same kernel (a prefill's first token):
    ``logits`` of one slot, ``spec`` None for greedy. The selection runs
    where ``logits`` lie; only the token comes back to the host."""
    flat = torch.as_tensor(logits).float().reshape(1, -1)
    row = SamplerRows.from_specs([spec], [position], device=flat.device)
    return int(sample_from_logits(flat, row)[0].item())
