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
  what the card ran for the caller. A meshed wave's collectives
  (``parallel.comm.launches``) are counted the same way.
* graph nodes: a capture keeps its ``cudaGraph_t`` (``keep_graph=True``)
  long enough to count its kernel, memcpy and memset nodes through the
  driver (:func:`graph_nodes`), then instantiates it; every replay adds
  them to :data:`REPLAYED` (four integer adds, whether or not a recorder
  reads them), and every capture counts in it too, so a
  recorder can read the nodes a wave replayed and see a capture that
  falls in a timed window.
* garbage: the cyclic collector runs before a capture and not during it,
  since freeing another graph while a stream captures invalidates the
  capture.

Leaf module: imports torch and the kernel wrappers' and collectives'
counters only.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc

import torch

from repro_torch.kernels import flash_attention, sectored_attention, vbl_gather
from repro_torch.parallel import comm

#: every kernel wrapper's launch counter and the collectives' (name ->
#: count dicts)
KERNEL_COUNTERS = (sectored_attention.launches,
                   sectored_attention.head_major_launches,
                   vbl_gather.launches, flash_attention.launches,
                   comm.launches)


# -- trees of tensors (dataclasses, dicts, tuples, lists) ---------------------
#
# A dict is walked in sorted-key order, so two trees of the same structure
# give their tensors in the same order; ``None`` (a hybrid stack's slot of
# the other layer kind) holds no tensor and maps to itself.


def leaves(tree):
    """The tensors of a dataclass / dict / tuple / list tree, in field
    (dict: sorted-key) order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from leaves(item)


def unflatten(tree, new_leaves):
    """``tree`` with its tensors replaced, in :func:`leaves` order, by
    ``new_leaves`` (as many tensors): the inverse of :func:`leaves`."""
    it = iter(new_leaves)

    def take(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: take(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            out = {key: take(t[key]) for key in sorted(t)}
            return {key: out[key] for key in t}
        if isinstance(t, (tuple, list)):
            return type(t)(take(item) for item in t)
        return t

    return take(tree)


def map_tree(fn, tree):
    """``tree`` with every tensor ``t`` replaced by ``fn(t)``; the
    structure (dataclasses, dicts, tuples, lists, ``None``) is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {key: map_tree(fn, item) for key, item in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, item) for item in tree)
    return tree


def clone_tree(tree):
    """A copy of ``tree`` with every tensor cloned."""
    return map_tree(torch.clone, tree)


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


# -- graph nodes -------------------------------------------------------------

#: CUgraphNodeType values counted apart (cuda.h), and a child graph's
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CHILD_GRAPH = 4


class Replayed:
    """Replays of graphs whose nodes were counted and their nodes by kind,
    since the process started, and the graphs captured (read as
    differences around a span)."""

    def __init__(self):
        self.graphs = self.kernel = self.memcpy = self.memset = 0
        self.captures = 0


REPLAYED = Replayed()


def _driver():
    """The CUDA driver library (loaded by any process on the card), or
    None."""
    try:
        return ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None


def graph_nodes(raw: int) -> dict | None:
    """Kernel, memcpy and memset nodes of the graph ``raw`` (a
    ``cudaGraph_t``), child graphs walked; None where the driver cannot
    be asked."""
    lib = _driver()
    if lib is None or not raw:
        return None
    counts = dict.fromkeys(NODE_KINDS.values(), 0)
    pending = [ctypes.c_void_p(raw)]
    while pending:
        graph = pending.pop()
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)):
            return None
        nodes = (ctypes.c_void_p * n.value)()
        if lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
            return None
        for node in nodes:
            kind = ctypes.c_int(-1)
            if lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)):
                return None
            if kind.value == _CHILD_GRAPH:
                child = ctypes.c_void_p()
                if lib.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node),
                                                     ctypes.byref(child)):
                    return None
                pending.append(child)
            elif kind.value in NODE_KINDS:
                counts[NODE_KINDS[kind.value]] += 1
    return counts


def _new_graph():
    """``(graph, kept)``: a graph that keeps its ``cudaGraph_t`` after
    the capture where this torch offers it (``kept``), else a plain one."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


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
    ``warmup_launches`` those of the warm-up, counted nowhere. ``nodes``
    holds the graph's kernel, memcpy and memset nodes (None where they
    could not be counted), added to :data:`REPLAYED` on every replay.
    """

    def __init__(self, body, *, pool=None, counters=KERNEL_COUNTERS):
        self.body = body
        self.pool = pool
        self.counters = counters
        self.graph = None
        self.launches: list[dict] | None = None
        self.warmup_launches: list[dict] | None = None
        self.nodes: dict | None = None

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
        if self.nodes is not None:
            REPLAYED.graphs += 1
            REPLAYED.kernel += self.nodes["kernel"]
            REPLAYED.memcpy += self.nodes["memcpy"]
            REPLAYED.memset += self.nodes["memset"]
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
        REPLAYED.captures += 1

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
        # a graph the cyclic garbage collector frees during the capture (a
        # dropped session's: sessions, handles and recorders form cycles)
        # is destroyed while the stream captures, which invalidates the
        # capture; collect before it and not during it
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            graph, kept = _new_graph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = self.body(*static)
        finally:
            if enabled:
                gc.enable()
        if kept:
            self.nodes = graph_nodes(graph.raw_cuda_graph())
            graph.instantiate()
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
