"""Serving steps as captured CUDA graphs: the port's counterpart of the JAX
package's ``jax.jit`` over a decode step, a fused wave and the prefill
scan.

The reference never runs a step eagerly: ``SectoredKVBackend._step_for``
jits the step, ``_prefill`` is one jitted scan and ``make_fused_wave`` is
``jit(vmap(...))``. In PyTorch one eager step is a Python launch per op
(thousands a step at full width), and the host, not the card, sets its
time. A CUDA graph records those launches once and replays them as one.

* :class:`CapturedStep` — ``body(state, token, *rest)`` captured on the
  card: the static inputs are the caller's state (and ``rest``, the
  sampler rows of a wave), written in place by every replay, and a token
  buffer of its own that each call copies the fresh token into. It warms
  the body up on a side stream over a scratch copy of every input, then
  captures on the same stream. A capture that fails raises: nothing runs
  eagerly in its place.
* :class:`Step` — a backend's decode step ``fn(state, token) -> (logits,
  new_state)`` over its in-place body ``step_(state, token) -> logits``:
  eager on the CPU or when graphs are off, a :class:`CapturedStep`
  otherwise; :meth:`Step.capture` captures a larger body (a fused wave,
  the prefill step) in the backend's memory pool.
* kernel launches: the wrappers count launches in Python, which a replay
  does not run. A capture records how many launches it holds and adds
  them to the counters on every replay; the warm-up's and the capture's
  own calls are taken back out (:func:`uncounted`), so the counters read
  what the card ran for the caller.

Leaf module: imports torch and the kernel wrappers' counters only.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels import flash_attention, sectored_attention, vbl_gather

#: every kernel wrapper's launch counter (name -> count dicts)
KERNEL_COUNTERS = (sectored_attention.launches,
                   sectored_attention.head_major_launches,
                   vbl_gather.launches, flash_attention.launches)


# -- trees of tensors (dataclasses, tuples) -----------------------------------


def leaves(tree):
    """The tensors of a dataclass / tuple / list tree, in field order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from leaves(item)


def clone_tree(tree):
    """A copy of ``tree`` with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: clone_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(item) for item in tree)
    return tree


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape


def copy_tree_(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor of ``dst`` at the same
    place, in place; tensors that already are the same memory are left
    alone (a step's new state shares its K/V buffers with the old one)."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        if not _same(d, s):
            d.copy_(s)


# -- launch accounting -------------------------------------------------------


@contextlib.contextmanager
def uncounted(counters=KERNEL_COUNTERS):
    """Run a block whose kernel launches are not the caller's (a warm-up
    on scratch inputs, a capture): the yielded list holds, once the block
    ends, the launches it made per counter, and the counters are put back
    to what they read before it."""
    before = [dict(c) for c in counters]
    made: list[dict] = []
    try:
        yield made
    finally:
        for c, b in zip(counters, before):
            made.append({k: n - b.get(k, 0) for k, n in c.items()})
            c.clear()
            c.update(b)


def add_launches(counters, made) -> None:
    """Add launches recorded by :func:`uncounted` to the counters (one
    replay of a captured graph)."""
    for c, m in zip(counters, made):
        for k, n in m.items():
            c[k] = c.get(k, 0) + n


# -- captured steps ----------------------------------------------------------


class CapturedStep:
    """``body(state, token, *rest)`` as one CUDA graph.

    The first call captures. It adopts ``state`` and ``rest`` as the
    graph's static inputs (the caller keeps them: every replay writes into
    them), copies ``token`` into a buffer of its own, runs ``body`` once on
    a side stream over a scratch copy of all inputs (so cuBLAS handles and
    workspaces, kernel libraries and kernel attributes are set up outside
    the capture, and the live state takes no phantom token), then captures
    ``body`` on the static inputs on that stream. Each call copies the
    fresh ``token`` into the static one and replays, and returns the
    graph's outputs (memory of the graph, overwritten by the next replay).

    A later call must pass the same state and ``rest`` tensors and a token
    of the same shape (``ValueError`` otherwise). A failed capture raises.

    ``launches`` holds the kernel launches one replay makes (per counter in
    ``counters``), added to the counters on every replay;
    ``warmup_launches`` those of the warm-up, counted nowhere.
    """

    def __init__(self, body, *, pool=None, counters=KERNEL_COUNTERS):
        self.body = body
        self.pool = pool
        self.counters = counters
        self.graph = None
        self.launches: list[dict] | None = None
        self.warmup_launches: list[dict] | None = None

    def __call__(self, state, token, *rest):
        if self.graph is None:
            self._capture(state, token, rest)
        else:
            if token.shape != self.token.shape:
                raise ValueError(
                    f"token of shape {tuple(token.shape)} for a step "
                    f"captured with {tuple(self.token.shape)}")
            if not all(map(_same, leaves((state, rest)), self._static)):
                raise ValueError(
                    "a captured step replays on the state it was captured "
                    "on; build another step (or pass graphs=False) for "
                    "another state")
            self.token.copy_(token)
        self.graph.replay()
        add_launches(self.counters, self.launches)
        return self.out

    def _capture(self, state, token, rest) -> None:
        self.token = token.clone()
        static = (state, self.token, *rest)
        self._static = list(leaves((state, rest)))
        with uncounted(self.counters) as warm:
            self._warm_up(clone_tree(static))
        self.warmup_launches = warm
        with uncounted(self.counters) as held:
            self.graph, self.out = self._record(static)
        self.launches = held

    def _warm_up(self, scratch) -> None:
        # the capture runs on this stream too: cuBLAS sets up its
        # workspace for the stream here, outside the capture
        device = self.token.device
        self.stream = torch.cuda.Stream(device=device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.body(*scratch)
        current.wait_stream(self.stream)

    def _record(self, static):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = self.body(*static)
        return graph, out


class Step:
    """A backend's decode step ``fn(state, token) -> (logits, new_state)``
    over its in-place body ``step_(state, token) -> logits``.

    Eager (``graphs`` False: a CPU backend, or ``graphs=False``): each
    call runs ``step_`` on ``state.fork()`` — the caller's K/V buffers
    take the new row, its length, table and position stay as they were —
    and returns the fork.
    Captured: the first call captures ``step_`` on the state it is given
    (see :class:`CapturedStep`); each call updates that state in place and
    returns it.

    :meth:`capture` makes a larger body over the same state (the fused
    wave, the prefill step) a :class:`CapturedStep` in the backend's
    memory pool, or returns it as it is when graphs are off.
    """

    def __init__(self, step_, *, graphs: bool, pool=None):
        self.step_ = step_
        self.graphs = graphs
        self.pool = pool
        self._captured = None

    def capture(self, body):
        if not self.graphs:
            return body
        return CapturedStep(body, pool=self.pool)

    def __call__(self, state, token):
        if self.graphs:
            if self._captured is None:
                self._captured = self.capture(self.step_)
            return self._captured(state, token), state
        new_state = state.fork()
        return self.step_(new_state, token), new_state
