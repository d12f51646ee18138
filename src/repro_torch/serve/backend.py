"""DecodeBackend container and the fused wave (counterpart of the JAX
package's ``serve/backend.py``).

A backend bundles the data path: ``prefill_fn``, dense ``decode_fn``,
``sectored_fn`` and ``demand_merge_fn``. :func:`fused_select_step`
composes a decode step with on-device token selection (greedy first-max,
or the full :mod:`repro_torch.sample` kernel), the stop guard and the
token's logprob; :func:`make_fused_wave` is the wave the session runs,
which writes the new state and sampler rows in place. The reference vmaps
a per-slot step over stacked slot states; here the slot axis IS the batch
axis of one state, so the wave is one batched call. Where the reference
jits the wave, a step that offers ``capture`` (a ``SectoredKVBackend``
step on the card) makes it one captured CUDA graph.

Leaf-level: imports nothing from ``repro_torch.runtime`` but its leaf
module ``graphs``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.runtime.graphs import copy_tree_
from repro_torch.sample import SamplerRows, sample_from_logits, token_logprob
from repro_torch.sample.kernel import greedy_select


class ServingBackend:
    """Concrete DecodeBackend over four loose callables."""

    def __init__(self, prefill_fn: Callable, decode_fn: Callable,
                 sectored_fn: Callable | None = None,
                 demand_merge_fn: Callable | None = None, *,
                 vocab: int | None = None):
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.sectored_fn = sectored_fn
        self.demand_merge_fn = demand_merge_fn
        # vocabulary bound: ServeSession.submit rejects stop tokens past it
        self.vocab = vocab

    @property
    def supports_sectored(self) -> bool:
        return self.sectored_fn is not None

    def sectored_fn_for(self, topk_frac: float | None) -> Callable:
        """The sectored step for a policy-requested top-k fraction; the
        base backend has one fixed step and ignores the hint."""
        if self.sectored_fn is None:
            raise ValueError("backend has no sectored decode path")
        return self.sectored_fn

    def merge_demands(self, stacked_state, group_ids):
        if self.demand_merge_fn is None:
            return stacked_state
        return self.demand_merge_fn(stacked_state, group_ids)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(sectored={self.supports_sectored}, "
                f"merge={self.demand_merge_fn is not None})")


def _select_(logits, token: torch.Tensor, rows: SamplerRows,
              sampled: bool):
    """Token selection with the stop guard, advancing ``rows`` and
    writing each token's logprob into ``rows.logp`` in place; returns the
    ``(slots, 1)`` int32 tokens.

    ``sampled`` False is first-max argmax with no sampling math; True is
    :func:`~repro_torch.sample.sample_from_logits`, whose greedy branch is
    the same argmax, so a greedy slot's token does not depend on the
    flavor its wave runs.

    Stop guard (the EOS contract): a slot whose INPUT token is in its
    stop set re-emits that token, keeps its RNG counter and reports
    logprob 0, so a finished slot can never emit past EOS.
    """
    tok = (sample_from_logits(logits, rows) if sampled
           else greedy_select(logits))
    last = token.reshape(token.shape[0], -1)[:, -1].to(torch.int32)
    stopped = torch.any(last[:, None] == rows.stop, dim=-1)
    tok = torch.where(stopped, last, tok)
    rows.logp.copy_(torch.where(stopped, 0.0, token_logprob(logits, tok)))
    rows.advance_(hold=stopped)
    return tok[:, None]


def fused_select_step(fn: Callable, *, sampled: bool = False) -> Callable:
    """Decode step with token selection fused in.

    Wraps ``fn(state, token) -> (logits, new_state)`` into
    ``fused(state, token, rows) -> (tok, new_state, advanced_rows)``;
    ``token`` and ``tok`` are ``(slots, 1)`` int32. ``rows`` is left as
    it was (see :func:`_select_` for ``sampled`` and the stop guard).
    """
    def fused(state, token: torch.Tensor, rows: SamplerRows):
        logits, new_state = fn(state, token)
        rows = rows.clone()
        return _select_(logits, token, rows, sampled), new_state, rows

    return fused


def _in_place(fn: Callable) -> Callable:
    """``step_(state, token) -> logits`` over a functional step: the new
    state is copied into ``state``."""
    def step_(state, token):
        logits, new_state = fn(state, token)
        copy_tree_(state, new_state)
        return logits
    return step_


def make_fused_wave(fn: Callable, *, sampled: bool = False) -> Callable:
    """The session's wave ``wave(state, token, rows) -> tok``: the decode
    step ``fn``, token selection (``sampled``: see :func:`_select_`), the
    stop guard and the logprob over all slots at once, writing the new
    state and advanced rows (with the logprobs) into ``state`` and
    ``rows``. ``tok`` is ``(slots, 1)`` int32. Memoization is the
    caller's (``ServeSession._wave_for`` caches per ``(id(fn),
    sampled)``).

    A step with an in-place body (``fn.step_``) runs it directly, and one
    that offers ``capture`` makes the whole wave one captured CUDA graph
    bound to the state and rows of its first call; any other functional
    step runs eagerly with its new state copied back.
    """
    step_ = getattr(fn, "step_", None) or _in_place(fn)

    def wave(state, token: torch.Tensor, rows: SamplerRows):
        return _select_(step_(state, token), token, rows, sampled)

    capture = getattr(fn, "capture", None)
    return capture(wave) if capture is not None else wave
