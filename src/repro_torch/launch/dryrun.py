"""Multi-pod dry run (counterpart of the JAX package's
``launch/dryrun.py``).

Traces every (architecture x input shape) cell on the production mesh —
16x16 single-pod and 2x16x16 multi-pod: rank 0's program (below) over
a fake process group (``launch.mesh.make_dryrun_mesh``: the collectives
return at once) and fake tensors (nothing is allocated). It records per
rank:

* FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode``;
* bytes accessed: every op's input and output bytes (:class:`CostMode`;
  a view moves none). The port runs eagerly, so no op is fused away;
* peak live bytes: every storage from its creation to its release, the
  step's arguments included (:class:`CostMode`);
* collective bytes by kind (``parallel.comm.collective_bytes``),

and the roofline terms on H100 datasheet figures (``launch/roofline.py``).

The rank programs: ``train``, ``make_train_step(cfg, mesh, fsdp=,
remat=True)`` on the rank's rows and blocks, the port's training mesh
as it runs: the partitioned layer program over 'model'
(``parallel.tensor``), each product split where its leaf's spec splits
it, so a rank's FLOPs are its part of the step's. The serving cells run
the port's serving functions (``model.prefill``/``forward``,
``model.decode_step_``) on the rank's rows with the same partitioned
program, the parameters stored as the training step stores them and
each layer's leaves gathered as the function reads them
(``train.step.serving_params``) over the data axes and, where 'model'
does not split a leaf's compute, over 'model'. That is a program the
port's serving mesh does not run: ``serve.MeshBackend`` keeps the
parameters whole on every rank (as the reference's does), which the
larger archs could not hold. ``prefill``: a frontend stub arch takes
precomputed embeddings. ``decode``: one token against the rank's block
of the KV cache, each layer's sequence over 'model' gathered before its
attention (which then reads the kv heads of the rank's query heads) and
the new row written back into the rank's block
(``train.step.gathered_state``, as ``make_decode_step`` runs it).
Variant ``sectored``: the sectored step's plain dispatch flavor
(``runtime.sectored_decode.mesh_step``, as ``make_sectored_decode_step``
runs it on a mesh) on a cache whose pages are split over 'model' (over
every axis for ``long_500k``), with the same partitioned program: each
rank attends its query heads over the selected pages of the kv heads
they read, gathered from the ranks that own them
(``parallel.comm.PageShard``), the table whole on every rank.

The layer loop is Python, so every layer is traced and counted (the
reference corrects XLA's once-counted scan bodies with probe
compiles; the port needs none). A per-token Python loop (RWKV's time
mix, the RG-LRU scan: ``LOOPS``) would be traced op by op, tens of
millions of ops in the attn-free and hybrid archs' train and prefill
cells, so those cells are taken in two parts (:func:`time_loop_cost`):

* the counts: the cell traced at three cut lengths (PROBE, 2 PROBE,
  3 PROBE tokens), each count taken at the cell's length through the
  quadratic the three give (:func:`extrapolate`; exact for FLOPs,
  bytes and collective bytes, polynomials of degree 2 at most in the
  length: linear layers and loops, quadratic attention scores);
* the peak and the arguments: one trace at the cell's length with each
  loop replaced by a :class:`LoopStandIn`, which holds and frees the
  memory the loop alone shows at that length (a peak is a maximum over
  the step, no polynomial in the length, so it is not extrapolated).
  At 96 tokens the stand-in's peak equals a direct trace's to the byte
  in the four loop cells of ``tests/test_torch_dryrun.py``. The loop
  is measured outside a remat region; where a step's peak falls inside
  the loop's own backward under remat, the stand-in can read low (its
  backward's transient is the loop's alone, without what the remat
  region holds around it).

RWKV's element-wise outer products, bonus and decay escape the FLOP
counter (it sees the per-token ``einsum``), so the reference's
analytic scan FLOPs are added for those five of its six multiply-adds
per head-dim².

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 8 --out results/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from fractions import Fraction

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import fake
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline
from repro_torch.models import griffin, model, rwkv
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding
from repro_torch.runtime import sectored_decode
from repro_torch.train import step as step_mod

#: archs whose params+optimizer need FSDP over the data axis
FSDP_ARCHS = {"qwen3-32b", "qwen2-72b", "qwen2-vl-72b", "kimi-k2-1t-a32b",
              "qwen3-moe-235b-a22b"}
#: trillion-scale MoEs keep AdamW moments in bf16
BF16_MOMENT_ARCHS = {"kimi-k2-1t-a32b", "qwen3-moe-235b-a22b"}
#: pure full-attention archs skip the *dense* long_500k cell (quadratic);
#: they run it through the sectored decode path instead (variant=sectored).
ATTENTION_ARCHS = {"musicgen-large", "chatglm3-6b", "qwen3-32b", "yi-6b",
                   "qwen2-72b", "qwen2-vl-72b", "kimi-k2-1t-a32b",
                   "qwen3-moe-235b-a22b"}


def input_specs(arch: str, shape: str, device="cpu"):
    """Fake tensors for every model input of this cell (global shapes)."""
    cfg = configs.get(arch)
    sc = configs.SHAPES[shape]
    B, S = sc.global_batch, sc.seq_len
    if sc.kind == "train":
        return dict(tokens=fake((B, S), torch.int32, device),
                    labels=fake((B, S), torch.int32, device))
    if sc.kind == "prefill":
        if cfg.frontend != "none":
            # [audio]/[vlm]: the modality frontend is a stub — inputs are
            # precomputed frame/patch embeddings.
            return dict(embeds=fake((B, S, cfg.d_model), torch.bfloat16,
                                    device))
        return dict(tokens=fake((B, S), torch.int32, device))
    return dict(token=fake((B, 1), torch.int32, device))


class CostMode(TorchDispatchMode):
    """Counts the bytes every op reads and writes (tensor inputs and
    outputs, each once; none for a view, an allocation, a collective or
    a metadata query) and tracks the bytes of every live storage:
    :meth:`hold` the step's arguments first, then ``peak`` is the most
    held at once."""

    #: collectives (``collective_bytes`` counts them) and metadata queries
    SKIP = ("c10d", "_c10d_functional", "prim")
    #: ops that move no data: allocations and views not tagged as views
    NO_BYTES = {"_unsafe_view", "empty", "empty_like", "empty_strided",
                "new_empty", "new_empty_strided"}

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._held: dict = {}

    def hold(self, tree) -> int:
        """Track every tensor of ``tree``; returns their bytes."""
        before = self.live
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def release(key=key, n=n):
            self.live -= n
            self._held.pop(key, None)

        self._held[key] = weakref.finalize(st, release)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in self.SKIP:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view and func._opname not in self.NO_BYTES:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            seen = {id(t) for t in ins}
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in ins + [t for t in outs if id(t) not in seen])
        for t in outs:
            self._track(t)
        return out


# -- the rank programs ---------------------------------------------------------


def _rows(n: int, mesh, long_ctx: bool) -> int:
    """This rank's rows of an ``n``-row global batch (a long-context batch
    is replicated)."""
    if long_ctx:
        return n
    return n // comm.MeshComm(mesh).data_shard()[1]


def _train_program(cfg, sc, mesh, fsdp: bool, dev):
    arch = cfg.name.split("~")[0]
    ocfg = adamw.AdamWConfig(moment_dtype="bfloat16"
                             if arch in BF16_MOMENT_ARCHS else "float32")
    fn, ins, _ = step_mod.make_train_step(cfg, mesh, opt_cfg=ocfg,
                                          fsdp=fsdp, remat=True)
    rows = _rows(sc.global_batch, mesh, False)

    def build():
        params = sharding.place(model.init_params(cfg, device=dev), ins[0],
                                mesh)
        batch = dict(
            tokens=torch.empty((rows, sc.seq_len), dtype=torch.int32,
                               device=dev),
            labels=torch.empty((rows, sc.seq_len), dtype=torch.int32,
                               device=dev))
        return fn, (params, adamw.init_state(params, ocfg), batch)
    return build


def _prefill_program(cfg, sc, mesh, dev, state_len: int):
    specs = sharding.param_shardings(
        mesh, sharding.abstract(model.init_params, cfg, device="cpu"))
    rows = _rows(sc.global_batch, mesh, False)
    hybrid = not (cfg.uniform_layers or cfg.attn_free)
    serving = step_mod.serving_params(cfg, mesh, specs)

    def fn(params, inputs):
        tree, tp = serving(params)
        if cfg.frontend != "none":
            hidden = model.forward(tree, cfg, embeds=inputs, tp=tp)
            return model.logits_fn(tree, cfg, hidden[:, -1:, :], tp)
        if hybrid:
            # a hybrid's local caches hold at most pad(window) rows, which
            # a long prompt overflows (model.prefill refuses it): the cell
            # is the reference's prefill of a non-uniform stack, the
            # forward pass, the last position's logits and a zero state
            hidden = model.forward(tree, cfg, inputs, tp=tp)
            return (model.logits_fn(tree, cfg, hidden[:, -1:, :], tp),
                    model.init_decode_state(cfg, rows, state_len,
                                            device=inputs.device))
        return model.prefill(tree, cfg, inputs, tp=tp)

    def build():
        params = sharding.place(model.init_params(cfg, device=dev), specs,
                                mesh)
        if cfg.frontend != "none":
            inputs = torch.empty((rows, sc.seq_len, cfg.d_model),
                                 dtype=torch.bfloat16, device=dev)
        else:
            inputs = torch.empty((rows, sc.seq_len), dtype=torch.int32,
                                 device=dev)
        return fn, (params, inputs)
    return build


def _decode_program(cfg, sc, mesh, variant: str, dev):
    long_ctx = sc.name == "long_500k"
    specs = sharding.param_shardings(
        mesh, sharding.abstract(model.init_params, cfg, device="cpu"))
    rows = _rows(sc.global_batch, mesh, long_ctx)
    mc = comm.MeshComm(mesh)
    sectored = variant == "sectored"
    if sectored:
        # the page shard reads whole pages of its block: the buffer is
        # padded to a whole number of pages a rank (the reference pads to
        # 8 pages)
        split = (mc.world if long_ctx else mc.sizes.get("model", 1))
        pages = -(-sectored_decode.padded_pages(sc.seq_len) // split) * split
        buf_len = pages * sectored_decode.PAGE_SIZE - 8
        shape = sharding.abstract(sectored_decode.init_state, cfg,
                                  sc.global_batch, buf_len, device="cpu")
        sspec = sharding.sectored_state_shardings(mesh, shape, long_ctx)
        k_pages = sectored_decode.topk_for(sc.seq_len,
                                           sectored_decode.TOPK_FRAC)
        step_ = sectored_decode.mesh_step(cfg, mesh, specs, sspec, shape,
                                          k_pages, long_context=long_ctx)
    else:
        shape = sharding.abstract(model.init_decode_state, cfg,
                                  sc.global_batch, sc.seq_len, device="cpu")
        sspec = sharding.decode_state_shardings(mesh, shape, long_ctx)
        serving = step_mod.serving_params(cfg, mesh, specs)

    def fn(params, state, token):
        if sectored:
            return step_(params, state, token)
        tree, tp = serving(params)
        view, close = step_mod.gathered_state(state, sspec, cfg.n_layers,
                                              mesh, mc)
        logits = model.decode_step_(tree, cfg, view, token, tp=tp)
        close()
        return logits

    def build():
        params = sharding.place(model.init_params(cfg, device=dev), specs,
                                mesh)
        if sectored:
            state = sectored_decode.init_state(cfg, sc.global_batch, buf_len,
                                               device=dev)
        else:
            state = model.init_decode_state(cfg, sc.global_batch, sc.seq_len,
                                            device=dev)
        state = sharding.place(state, sspec, mesh)
        token = torch.empty((rows, 1), dtype=torch.int32, device=dev)
        return fn, (params, state, token)
    return build


def trace_cell(cfg, sc, mesh, variant: str = "dense", *, fsdp: bool = False,
               device="cpu",
               state_len: int | None = None) -> roofline.StepCost:
    """Run one rank's program of the cell over fake tensors; what it
    costs. ``state_len``: the decode state a hybrid's prefill returns is
    sized for it (default the cell's length)."""
    if sc.kind == "train":
        build = _train_program(cfg, sc, mesh, fsdp, device)
    elif sc.kind == "prefill":
        build = _prefill_program(cfg, sc, mesh, device,
                                 state_len or sc.seq_len)
    else:
        build = _decode_program(cfg, sc, mesh, variant, device)
    with FakeTensorMode():
        fn, args = build()
        cost = CostMode()
        arg_bytes = cost.hold(args)
        comm.reset_bytes()
        grad = torch.enable_grad() if sc.kind == "train" else torch.no_grad()
        with grad, FlopCounterMode(display=False) as flops, cost:
            out = fn(*args)
            del out
    return roofline.StepCost(flops=flops.get_total_flops(),
                             bytes_accessed=cost.bytes_accessed,
                             peak_bytes=cost.peak, arg_bytes=arg_bytes,
                             coll=roofline.collective_bytes())


#: the cut lengths a per-token loop's cell is traced at (PROBE, 2 PROBE,
#: 3 PROBE tokens)
PROBE = 16

#: the per-token Python loops, as (module, function name): each takes and
#: returns a flat tuple of tensors
LOOPS = ((rwkv, "wkv_scan"), (griffin, "scan"))


def has_time_loop(cfg, sc) -> bool:
    """Whether the cell runs a per-token Python loop over its sequence:
    RWKV's time mix and the RG-LRU scan, in a training step or a
    prefill."""
    return (sc.kind != "decode" and not cfg.uniform_layers
            and sc.seq_len > 3 * PROBE)


@contextlib.contextmanager
def _loops_replaced(make):
    """Each loop ``fn`` of :data:`LOOPS` replaced by ``make(key, fn)``
    for the block (``key``: its (module, name)), put back after it."""
    was = {key: getattr(*key) for key in LOOPS}
    try:
        for key, fn in was.items():
            setattr(*key, make(key, fn))
        yield
    finally:
        for key, fn in was.items():
            setattr(*key, fn)


def _meta(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.requires_grad)
                 for t in tensors)


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class LoopBytes:
    """A per-token loop's memory, in bytes: ``nograd`` its peak above its
    inputs under ``no_grad``; with autograd recording, ``fwd`` its peak
    above its inputs, ``kept`` what stays live for the backward once the
    outputs no gradient reaches are dropped, beyond its outputs and the
    inputs it saves (``held``: their indices), and ``bwd`` the backward's
    peak above what was live when it began."""

    nograd: int
    fwd: int = 0
    kept: int = 0
    bwd: int = 0
    held: tuple = ()


class LoopStandIn:
    """A per-token loop's stand-in for the peak of a full-length trace:
    its outputs at the shapes the loop gives, and its memory as the loop
    run alone at the same length shows it (:class:`LoopBytes`; the loop
    alone is a few hundred thousand fake ops where the whole step is tens
    of millions). It allocates and frees that memory in the loop's
    order and saves for the backward what the loop saves, so autograd
    and a remat region hold and drop it as they would the loop's; it
    moves no data.

    ``calls``: each cut length -> the (inputs, outputs) metadata of the
    loop's calls at it (one signature a length), which give the shapes
    at any length; ``grads``: the indices of the outputs a gradient
    reached there (the backward is measured from those alone); ``n``:
    the length it stands in at. It measures the loop when made: under a
    trace's modes the loop's ops would count as the trace's."""

    def __init__(self, fn, calls: dict, grads: set, n: int):
        self.points = sorted(calls)
        sigs = []
        for cut in self.points:
            if len(calls[cut]) != 1:
                raise ValueError(f"{fn.__name__}: {len(calls[cut])} call "
                                 f"signatures at length {cut}")
            sigs.append(next(iter(calls[cut])))
        self.fn = fn
        self.ins = self._template([s[0] for s in sigs])
        self.outs = self._template([s[1] for s in sigs])
        self.grads = sorted(grads)
        self.n = n
        self.bytes = self._measure(n)

    def _template(self, metas: list) -> list:
        """(shape with None at each length dim, dtype, requires_grad) of
        each tensor, from its metadata at the cut lengths."""
        out = []
        for parts in zip(*metas):
            shape = []
            for sizes in zip(*(p[0] for p in parts)):
                if len(set(sizes)) == 1:
                    shape.append(sizes[0])
                elif list(sizes) == self.points:
                    shape.append(None)
                else:
                    raise ValueError(f"dim sizes {sizes} at lengths "
                                     f"{self.points}")
            out.append((tuple(shape), parts[0][1], parts[0][2]))
        return out

    @staticmethod
    def _shapes_at(template: list, n: int) -> list:
        return [(tuple(n if d is None else d for d in shape), dtype, rg)
                for shape, dtype, rg in template]

    def _measure(self, n: int) -> LoopBytes:
        """The loop run alone at length ``n`` over fake tensors."""
        with FakeTensorMode():
            cost = CostMode()
            with cost:
                ins = [torch.empty(shape, dtype=dtype).requires_grad_(rg)
                       for shape, dtype, rg in self._shapes_at(self.ins, n)]
                base = cost.live
                with torch.no_grad():
                    out = self.fn(*ins)
                nograd = cost.peak - base
                del out
                if not any(t.requires_grad for t in ins):
                    return LoopBytes(nograd=nograd)
                cost.peak = cost.live
                saved = {}

                def pack(t):
                    st = t.untyped_storage()
                    saved[st._cdata] = st.nbytes()
                    return t

                with torch.autograd.graph.saved_tensors_hooks(
                        pack, lambda t: t):
                    outs = list(self.fn(*ins))
                fwd = cost.peak - base
                key = [t.untyped_storage()._cdata for t in ins + outs]
                if any(k in saved for k in key[len(ins):]):
                    raise ValueError(f"{self.fn.__name__} saves an output: "
                                     "its stand-in would not hold it")
                # an output no gradient reaches (the last state) is
                # dropped, as the step drops it, and with it what only its
                # ops saved
                live = [outs[j] for j in self.grads]
                del outs
                kept = cost.live - base - _tensor_bytes(live)
                gouts = [torch.empty_like(t) for t in live]
                start = cost.live
                cost.peak = start
                torch.autograd.grad(live, [t for t in ins if t.requires_grad],
                                    gouts, allow_unused=True)
                return LoopBytes(
                    nograd=nograd, fwd=fwd, kept=kept,
                    bwd=cost.peak - start,
                    held=tuple(i for i, k in enumerate(key[:len(ins)])
                               if k in saved))

    def outputs(self, device) -> list:
        return [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype, _ in self._shapes_at(self.outs, self.n)]

    def __call__(self, *args):
        if [m[:2] for m in _meta(args)] != [
                m[:2] for m in self._shapes_at(self.ins, self.n)]:
            raise ValueError(f"{self.fn.__name__}: called with "
                             f"{_meta(args)}, measured at {self.ins} "
                             f"at length {self.n}")
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return _StandIn.apply(self, *args)
        outs = self.outputs(args[0].device)
        torch.empty(self.bytes.nograd - _tensor_bytes(outs),
                    dtype=torch.uint8, device=args[0].device)
        return tuple(outs)


class _StandIn(torch.autograd.Function):
    """:class:`LoopStandIn` with autograd recording: the outputs, the
    bytes autograd keeps (saved, so a remat region drops and recomputes
    them as the loop's), the forward's and the backward's transients."""

    @staticmethod
    def forward(ctx, plan, *args):
        b, dev = plan.bytes, args[0].device
        outs = plan.outputs(dev)
        kept = torch.empty(b.kept, dtype=torch.uint8, device=dev)
        torch.empty(b.fwd - _tensor_bytes(outs) - b.kept, dtype=torch.uint8,
                    device=dev)
        ctx.save_for_backward(*(args[i] for i in b.held), kept)
        ctx.b, ctx.dev = b, dev
        # an output the loss does not reach (the last state) gets no
        # gradient, as the loop's would not: none made of zeros
        ctx.set_materialize_grads(False)
        ctx.in_meta = [(a.shape, a.dtype) for a in args]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        out = [torch.empty(shape, dtype=dtype, device=ctx.dev) if want
               else None for (shape, dtype), want in zip(ctx.in_meta, need)]
        grads = [t for t in out if t is not None]
        torch.empty(ctx.b.bwd - _tensor_bytes(grads), dtype=torch.uint8,
                    device=ctx.dev)
        return (None, *out)


def _at(points: list, values: list, x: int):
    """The quadratic through ``(points[i], values[i])`` at ``x``, in exact
    rational arithmetic."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(points, values)):
        term = Fraction(yi)
        for j, xj in enumerate(points):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def extrapolate(costs: list, points: list, x: int) -> dict:
    """A cell's counts at length ``x`` from its costs at ``points``
    (three cut lengths), each through the quadratic in the length:
    FLOPs, bytes accessed and collective bytes (a peak is no polynomial
    in the length and is not taken this way)."""
    def at(get):
        return _at(points, [get(c) for c in costs], x)
    return dict(
        flops=float(at(lambda c: c.flops)),
        bytes_accessed=float(at(lambda c: c.bytes_accessed)),
        coll={k: int(at(lambda c: c.coll[k])) for k in costs[0].coll})


def time_loop_cost(cfg, sc, mesh, variant: str = "dense", *,
                   fsdp: bool = False, device="cpu") -> roofline.StepCost:
    """A per-token loop's cell: its counts traced at the three cut
    lengths with the loops run as they are and taken at the cell's
    length (:func:`extrapolate`); its peak and argument bytes from one
    trace at the cell's length with each loop replaced by its
    :class:`LoopStandIn`, measured from the loop's calls in the cut
    traces."""
    points = [PROBE, 2 * PROBE, 3 * PROBE]
    calls = {key: {} for key in LOOPS}
    grads = {key: set() for key in LOOPS}

    def recording(key, fn):
        def call(*args):
            out = fn(*args)
            calls[key].setdefault(args[0].shape[1], set()).add(
                (_meta(args), _meta(out)))
            for j, t in enumerate(out):
                if t.requires_grad:
                    t.register_hook(lambda g, j=j: grads[key].add(j))
            return out
        return call

    with _loops_replaced(recording):
        costs = [trace_cell(cfg, dataclasses.replace(sc, seq_len=n), mesh,
                            variant, fsdp=fsdp, device=device,
                            state_len=sc.seq_len) for n in points]
    plans = {key: LoopStandIn(getattr(*key), c, grads[key], sc.seq_len)
             for key, c in calls.items() if c}
    with _loops_replaced(lambda key, fn: plans.get(key, fn)):
        full = trace_cell(cfg, sc, mesh, variant, fsdp=fsdp, device=device)
    return dataclasses.replace(full, **extrapolate(costs, points,
                                                   sc.seq_len))


def rwkv_uncounted_flops(cfg, sc, rows: int) -> float:
    """The reference's analytic RWKV scan FLOPs for this rank's tokens (6
    multiply-adds per head-dim² per token per layer, ×3 for a training
    step), less the one the FLOP counter sees (the state read, an
    ``einsum``)."""
    h, hd = rwkv.n_heads(cfg), cfg.rwkv_head_dim
    tokens = rows * (sc.seq_len if sc.kind != "decode" else 1)
    flops = 2.0 * 5 * h * hd * hd * tokens * cfg.n_layers
    return flops * 3 if sc.kind == "train" else flops


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in sharding.mesh_axes(mesh).values())


def lower_cell(arch: str, shape: str, multi_pod: bool,
               variant: str = "dense", *, mesh=None, cfg=None,
               device="cpu", fsdp: bool | None = None):
    """Trace one (arch, shape, mesh) cell; returns ``(cost, roofline)``.
    ``mesh`` (a dry-run mesh, see ``launch.mesh.make_dryrun_mesh``) is
    made for the call when None; ``cfg`` overrides the arch's config
    (a cut of it)."""
    if mesh is None:
        with mesh_mod.make_dryrun_mesh(multi_pod) as mesh:
            return lower_cell(arch, shape, multi_pod, variant, mesh=mesh,
                              cfg=cfg, device=device, fsdp=fsdp)
    cfg = cfg or configs.get(arch)
    sc = configs.SHAPES[shape] if isinstance(shape, str) else shape
    fsdp = arch in FSDP_ARCHS if fsdp is None else fsdp
    if has_time_loop(cfg, sc):
        cost = time_loop_cost(cfg, sc, mesh, variant, fsdp=fsdp,
                              device=device)
    else:
        cost = trace_cell(cfg, sc, mesh, variant, fsdp=fsdp, device=device)
    if cfg.attn_free:
        cost.flops += rwkv_uncounted_flops(
            cfg, sc, _rows(sc.global_batch, mesh, sc.name == "long_500k"))
    chips = comm.MeshComm(mesh).world
    rf = roofline.analyze(cost, arch=arch, shape=sc.name,
                          mesh_name=mesh_name(mesh), chips=chips,
                          model_flops=roofline.model_flops_for(cfg, sc))
    if variant != "dense":
        rf.shape = f"{sc.name}@{variant}"
    return cost, rf


def cells_for(arch: str):
    """(shape, variant) cells for an arch, honoring the long_500k rule."""
    out = [("train_4k", "dense"), ("prefill_32k", "dense"),
           ("decode_32k", "dense")]
    if arch in ATTENTION_ARCHS:
        # dense long_500k skipped (quadratic full attention); the
        # paper-representative sectored path runs it sub-quadratically.
        out.append(("long_500k", "sectored"))
    else:
        out.append(("long_500k", "dense"))
    return out


def record(cost: roofline.StepCost, rf: roofline.Roofline,
           seconds: float) -> dict:
    """A JSONL row: the reference's keys (``compile_s`` is the trace's
    seconds here)."""
    rec = rf.row()
    rec["compile_s"] = round(seconds, 1)
    rec["arg_gib"] = cost.arg_bytes / 2**30
    rec["temp_gib"] = (cost.peak_bytes - cost.arg_bytes) / 2**30
    return rec


def _run_parallel(mesh_names: list, jobs: int, out: str | None,
                  extra: list) -> int:
    """Every arch's cells on each mesh, one process per (arch, mesh),
    ``jobs`` at a time, each given the flags ``extra``; each process's
    output printed and its rows appended to ``out`` in (mesh, arch)
    order. Returns the failed processes."""
    work = [(a, m) for m in mesh_names for a in configs.ARCHS]
    failures = 0
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        def run(i, arch, mesh):
            part = os.path.join(tmp, f"{i}.jsonl")
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--mesh", mesh, "--out", part, *extra],
                capture_output=True, text=True)
            return proc, part

        for fut in [pool.submit(run, i, a, m)
                    for i, (a, m) in enumerate(work)]:
            proc, part = fut.result()
            print(proc.stdout + proc.stderr, end="", flush=True)
            failures += proc.returncode != 0
            if out and os.path.exists(part):
                with open(part) as src, open(out, "a") as dst:
                    dst.write(src.read())
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help="one shape (default: every cell of --arch)")
    ap.add_argument("--skip-shape", default=None,
                    help="with --arch alone: every cell but this shape's")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: this many processes at a time, one "
                         "(arch, mesh) each")
    # a cut of a cell (the smoke test's check of the dry run on the card)
    ap.add_argument("--spec", default=None,
                    help="a 'd'/'dxm' fake mesh in place of --mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke-scale config")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--fsdp", action="store_true",
                    help="fsdp for every arch (default: FSDP_ARCHS)")
    ap.add_argument("--device", default="cpu",
                    help="the fake tensors' device (cpu or cuda)")
    args = ap.parse_args(argv)

    if args.jobs > 1:
        if not args.all or args.spec:
            ap.error("--jobs runs --all on --mesh")
        names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        extra = ["--device", args.device]
        for flag in ("reduced", "fsdp"):
            extra += [f"--{flag}"] if getattr(args, flag) else []
        for flag in ("n_layers", "seq_len", "global_batch"):
            if getattr(args, flag):
                extra += [f"--{flag.replace('_', '-')}",
                          str(getattr(args, flag))]
        sys.exit(1 if _run_parallel(names, args.jobs, args.out, extra)
                 else 0)
    if args.all:
        cells = [(a, s, v) for a in configs.ARCHS for (s, v) in cells_for(a)]
    elif args.shape is None:
        cells = [(args.arch, s, v) for (s, v) in cells_for(args.arch)
                 if s != args.skip_shape]
    else:
        v = args.variant or ("sectored" if (args.shape == "long_500k" and
                                            args.arch in ATTENTION_ARCHS)
                             else "dense")
        cells = [(args.arch, args.shape, v)]

    if args.spec:
        meshes = [("spec", dict(spec=args.spec))]
    else:
        meshes = [(m, dict(multi_pod=m == "multi"))
                  for m in {"single": ["single"], "multi": ["multi"],
                            "both": ["single", "multi"]}[args.mesh]]
    out_f = open(args.out, "a") if args.out else None
    failures = 0
    for name, kw in meshes:
        with mesh_mod.make_dryrun_mesh(**kw) as mesh:
            for arch, shape, variant in cells:
                tag = f"{arch}/{shape}@{variant}/{name}"
                t0 = time.time()
                try:
                    cfg = configs.get(arch)
                    if args.reduced:
                        cfg = cfg.reduced()
                    if args.n_layers:
                        cfg = dataclasses.replace(cfg,
                                                  n_layers=args.n_layers)
                    sc = configs.SHAPES[shape]
                    sc = dataclasses.replace(
                        sc, seq_len=args.seq_len or sc.seq_len,
                        global_batch=args.global_batch or sc.global_batch)
                    cost, rf = lower_cell(
                        arch, sc, name == "multi", variant, mesh=mesh,
                        cfg=cfg, device=args.device,
                        fsdp=True if args.fsdp else None)
                    rec = record(cost, rf, time.time() - t0)
                    print(f"OK   {tag}: bottleneck={rf.bottleneck} "
                          f"t=({rf.t_compute:.4f},{rf.t_memory:.4f},"
                          f"{rf.t_collective:.4f})s "
                          f"mem={rec['peak_memory_gib']:.2f}GiB "
                          f"rooffrac={rf.roofline_fraction:.3f} "
                          f"[{rec['compile_s']}s]", flush=True)
                    print(f"     cost: flops/dev={cost.flops:.6e} "
                          f"bytes/dev={cost.bytes_accessed:.3e} "
                          f"arg={rec['arg_gib']:.2f}GiB "
                          f"temp={rec['temp_gib']:.2f}GiB "
                          f"coll={rf.coll_breakdown}", flush=True)
                    if out_f:
                        out_f.write(json.dumps(rec) + "\n")
                        out_f.flush()
                except Exception:
                    failures += 1
                    print(f"FAIL {tag}", flush=True)
                    traceback.print_exc()
    if out_f:
        out_f.close()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
