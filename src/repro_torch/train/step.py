"""The training step factory (counterpart of the JAX package's
``train/step.py``).

``make_train_step`` builds the ``(params, opt_state, batch) -> (params,
opt_state, {"loss"})`` function: the LM loss and its gradients by
``torch.autograd.grad`` over the parameter leaves (so no ``.grad`` is
left on any tensor), optionally accumulated in f32 over microbatches,
then one AdamW update. The step is functional, as the reference's: its
inputs are left as they were, so a caller can retry from them.

The step runs under :func:`deterministic`: on the card several backward
passes add with atomics (the embedding's and every advanced index's
scatter, ``xt[sorted_token]`` and ``contrib[by_token]`` in the MoE layer),
and PyTorch's deterministic algorithms replace them by sorted,
ordered ones, so a retried or restarted step gives the same bits. The
mode is switched on for the step only; the serving paths are untouched.

Every factory returns its step with the partition specs of
:mod:`repro_torch.parallel.sharding` (over fake-tensor shapes), as the
reference's do for its dry run.

Over a mesh (a ``DeviceMesh``; SPMD, one process per device, as the
serving mesh) the training step is each rank's program: the rank gets
its rows of the batch (over ``pod``/``data``) and holds its blocks of
the parameters and of the optimizer state under ``param_shardings(mesh,
fsdp=)``, and runs the partitioned layer program over ``model``
(``parallel.tensor``; the reference's SPMD partitioner splits the
compute the same way). Each parameter is gathered just before use
(``parallel.comm.gather_param``) over the data axes, and over ``model``
only where ``model`` does not split its compute (a leaf whole over
``model``, or split on its layer axis); a leaf split on an output or a
contraction dim keeps its ``model`` block and the layer computes its
part. The leaves outside the layer stack are gathered once a step, each
layer's inside the layer's remat region, so under ``fsdp`` a layer is
whole over the data axes only while it runs and is gathered again for
its recompute (ZeRO-3). The gathers' backward sums the gradients over
the data ranks in f32 and in rank order, so a step over ``D`` data ranks
and one ``model`` rank gives the bits of the unmeshed step with
``microbatch=D`` (where the global norm does not clip). Over ``model``
every rank holds the same bits of every replicated activation, of the
loss and of each whole leaf's gradient; a split contraction sums in
another order than the unsplit product, so a ``model`` group of two or
more ranks agrees with the unmeshed step within rounding, as the
reference's partitioned program does. The AdamW update runs on the
rank's blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch
import torch.utils.deterministic

from repro_torch.models import attention, model
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding, tensor
from repro_torch.runtime.graphs import leaves, unflatten

#: the cuBLAS workspace setting deterministic mode requires on the card
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block, put back as they
    were after it. Sets ``CUBLAS_WORKSPACE_CONFIG`` where it is unset
    (cuBLAS refuses deterministic mode without it) and leaves memory
    from ``torch.empty`` unfilled (deterministic mode would fill every
    allocation; each op here writes all of its output)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def value_and_grad(params, cfg, tokens, labels, *, remat: bool = False):
    """``(loss, grads)`` of :func:`repro_torch.models.model.lm_loss`:
    grads a list in :func:`leaves` order, each in its parameter's dtype
    (zeros for a parameter the loss does not reach)."""
    ps = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = model.lm_loss(unflatten(params, ps), cfg, tokens, labels,
                         remat=remat)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, grads)]


#: the specs of an unmeshed step: one device, the reference's axes
ONE_DEVICE = sharding.MeshShape((1, 1), ("data", "model"))


def make_train_step(cfg, mesh=None, *,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    fsdp: bool = False, remat: bool = True,
                    microbatch: int = 1):
    """``(train_step, in_specs, out_specs)``, as the reference's: the
    specs are ``(param_specs, opt_specs, dict(tokens=, labels=))`` in and
    ``(param_specs, opt_specs, P())`` out (over a one-device mesh when
    ``mesh`` is None). The step carries ``mesh`` and ``in_specs`` as
    attributes (the loop reads them).

    With ``microbatch > 1`` the (rank's) batch splits into that many
    equal parts along its rows; their f32 gradients and losses are
    summed in order, then divided by ``microbatch`` (the reference's
    ``lax.scan``, as a loop). Over a mesh, see the module docstring."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    spec_mesh = mesh if mesh is not None else ONE_DEVICE
    pspec = sharding.param_shardings(
        spec_mesh, sharding.abstract(model.init_params, cfg, device="cpu"),
        fsdp=fsdp)
    ospec = sharding.opt_state_shardings(pspec, opt_cfg)
    bspec = dict(tokens=sharding.batch_sharding(spec_mesh),
                 labels=sharding.batch_sharding(spec_mesh))
    in_specs = (pspec, ospec, bspec)
    out_specs = (pspec, ospec, sharding.P())
    if mesh is None:
        fn = _plain_step(cfg, opt_cfg, remat, microbatch)
    else:
        fn = _mesh_step(cfg, mesh, pspec, opt_cfg, remat, microbatch)
    fn.mesh, fn.in_specs = mesh, in_specs
    return fn, in_specs, out_specs


def _split(t: torch.Tensor, parts: int) -> torch.Tensor:
    return t.reshape(parts, t.shape[0] // parts, -1)


def _accumulate(vg, params, tokens, labels, microbatch: int):
    """``(loss, grads)`` of ``vg(params, tokens, labels)`` over the batch:
    with ``microbatch > 1`` its equal row parts' f32 gradients and losses
    summed in order, undivided (the reference's ``lax.scan``, as a
    loop)."""
    if microbatch == 1:
        return vg(params, tokens, labels)
    tk, lb = _split(tokens, microbatch), _split(labels, microbatch)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves(params)]
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(microbatch):
        l, g = vg(params, tk[i], lb[i])
        grads = [a + b.float() for a, b in zip(grads, g)]
        loss = loss + l
        del g
    return loss, grads


def _train_step(vg, opt_cfg, microbatch: int, n: int, sum_loss=None,
                **update):
    """The step: :func:`_accumulate`, the loss summed by ``sum_loss``
    (over a mesh's data ranks), loss and gradients divided by ``n`` (the
    microbatches the sum holds), then the AdamW update (``update``: its
    mesh arguments)."""
    def train_step(params, opt_state, batch):
        with deterministic():
            loss, grads = _accumulate(vg, params, batch["tokens"],
                                      batch["labels"], microbatch)
            if sum_loss is not None:
                loss = sum_loss(loss)
            if n > 1:
                grads = [g / n for g in grads]
                loss = loss / n
            new_params, new_opt = adamw.update_leaves(
                params, grads, opt_state, opt_cfg, **update)
        return new_params, new_opt, dict(loss=loss)

    return train_step


def _plain_step(cfg, opt_cfg, remat, microbatch):
    return _train_step(
        lambda p, tk, lb: value_and_grad(p, cfg, tk, lb, remat=remat),
        opt_cfg, microbatch, microbatch)


def layer_slots(params, n_layers: int) -> tuple[list, list]:
    """``(top, per_layer)``: the :func:`leaves` indices of the leaves
    outside ``params["layers"]``, and for each layer ``i`` the indices of
    the leaves ``model.layer_params(params, i)`` slices, in their
    ``leaves`` order (a stacked layer's are its stacked leaves)."""
    top, per_layer, start = [], [], 0
    for key in sorted(params):
        n = sum(1 for _ in leaves(params[key]))
        if key != "layers":
            top.extend(range(start, start + n))
        elif isinstance(params[key], list):
            o = start
            for lp in params[key]:
                m = sum(1 for _ in leaves(lp))
                per_layer.append(list(range(o, o + m)))
                o += m
        else:
            per_layer = [list(range(start, start + n))] * n_layers
        start += n
    return top, per_layer


class _GradSink:
    """Collects the reduced gradient blocks the parameter gathers' backward
    hands out (``(leaf, layer)`` keys), straight into one buffer per
    leaf: a stacked leaf's layers into its slices."""

    def __init__(self, n: int, n_layers: int):
        self.grads: list = [None] * n
        self.n_layers = n_layers

    def __call__(self, key, g: torch.Tensor) -> None:
        j, layer = key
        if layer is None:
            self.grads[j] = g
            return
        if self.grads[j] is None:
            self.grads[j] = g.new_zeros((self.n_layers, *g.shape))
        self.grads[j][layer].copy_(g)

    def result(self, blocks: list, dtype_of) -> list:
        """The gradients, zeros where a leaf got none."""
        return [torch.zeros(b.shape, dtype=dtype_of(b), device=b.device)
                if g is None else g for g, b in zip(self.grads, blocks)]


def _keep_model(spec, land: sharding.Landing):
    """``spec`` without 'model' where the leaf's compute is split over it
    (its landing an output or contraction dim): what the gather makes
    whole."""
    if not land.split:
        return spec
    return sharding.P(*(None if e == "model" else e for e in spec))


def mesh_params(params, cfg, specs: list, gather, lands=None):
    """``(tree, layer_hook)`` for a model call on a rank's blocks:
    ``params`` holds the blocks under ``specs`` (a list in :func:`leaves`
    order); ``gather(t, spec, key)`` makes a block whole over the axes
    ``spec`` names (``key``: ``(leaf index, layer or None)``). The leaves
    outside the layers, and a stacked leaf whose layer axis the rules
    split ('model' re-homed there when a dim it should split is too
    small, e.g. GQA's kv heads), are gathered once in ``tree``; every
    other layer leaf by ``layer_hook`` as its layer runs. ``lands`` (the
    :class:`sharding.Landing` of each leaf, in ``leaves`` order) keeps
    each leaf split over 'model' on an output or contraction dim as its
    'model' block (the partitioned program's operand)."""
    top, per_layer = layer_slots(params, cfg.n_layers)
    stacked = not isinstance(params["layers"], list)
    if lands is not None:
        specs = [_keep_model(s, land) for s, land in zip(specs, lands,
                                                         strict=True)]
    whole = set(top)
    if stacked:
        whole |= {j for j in per_layer[0] if specs[j][0] is not None}
    tree = list(leaves(params))
    for j in sorted(whole):
        tree[j] = gather(tree[j], specs[j], (j, None))

    def hook(i, lp):
        return unflatten(lp, [
            t if j in whole else gather(
                t, sharding.P(*specs[j][1:]) if stacked else specs[j],
                (j, i if stacked else None))
            for t, j in zip(leaves(lp), per_layer[i])])

    return unflatten(params, tree), hook


def split_context(mesh, cfg, pspec):
    """``(tp, lands)`` of this rank on ``mesh`` for the parameters under
    the spec tree ``pspec``: its :class:`tensor.TP` and each leaf's
    landing in :func:`leaves` order."""
    shapes = sharding.abstract(model.init_params, cfg, device="cpu")
    tp = tensor.context(mesh, shapes, pspec)
    return tp, sharding.landing_leaves(tp.lands)


def mesh_value_and_grad(params, cfg, tokens, labels, mc, specs: list, *,
                        remat: bool = True, tp=tensor.UNSPLIT, lands=None):
    """``(loss, grads)`` of the rank's rows on a mesh: ``params`` holds
    the rank's blocks under ``specs`` (a list in :func:`leaves` order),
    each gathered before use (:func:`mesh_params`) and run through the
    partitioned program of ``tp`` (``lands``: :func:`split_context`;
    by default every leaf gathered whole, the unsplit program); ``grads``
    are the rank's blocks of the gradient summed over the data ranks
    (f32, undivided), or of its own gradient in the parameter's dtype
    with one data rank."""
    blocks = list(leaves(params))
    ps = [p.detach().requires_grad_(True) for p in blocks]
    sink = _GradSink(len(ps), cfg.n_layers)
    tree, hook = mesh_params(
        unflatten(params, ps), cfg, specs,
        lambda t, spec, key: comm.gather_param(t, mc, spec, sink, key),
        lands)
    loss = model.lm_loss(tree, cfg, tokens, labels, remat=remat,
                         layer_hook=hook, tp=tp)
    torch.autograd.grad(loss, ps, allow_unused=True)
    one = mc.n_data == 1
    return loss.detach(), sink.result(
        blocks, lambda b: b.dtype if one else torch.float32)


def _mesh_step(cfg, mesh, pspec, opt_cfg, remat, microbatch):
    if isinstance(mesh, sharding.MeshShape):
        def specs_only(*args):
            raise TypeError("a MeshShape gives the specs only; the step "
                            "runs on a DeviceMesh")
        specs_only.mesh_comm = None
        return specs_only
    mc = comm.MeshComm(mesh)
    specs = list(sharding.spec_leaves(pspec))
    tp, lands = split_context(mesh, cfg, pspec)
    train_step = _train_step(
        lambda p, tk, lb: mesh_value_and_grad(p, cfg, tk, lb, mc, specs,
                                              remat=remat, tp=tp,
                                              lands=lands),
        opt_cfg, microbatch, microbatch * mc.n_data,
        mc.sum_over_data if mc.n_data > 1 else None, mesh_comm=mc,
        specs=specs)
    train_step.mesh_comm, train_step.tp = mc, tp
    return train_step


def _param_specs(cfg, mesh):
    return sharding.param_shardings(
        mesh, sharding.abstract(model.init_params, cfg, device="cpu"))


class GatheredList(list):
    """A list whose entry ``i`` is ``get(i)``, made when read.
    ``model.layer_params`` and ``DecodeState.layer_kv``/``layer_rec``
    read a list entry by entry, so a serving function handed one gathers
    each layer's parameters or state as the layer runs and drops it
    after."""

    def __init__(self, n: int, get):
        super().__init__([None] * n)
        self._get = get

    def __getitem__(self, i):
        return self._get(i)

    def __iter__(self):
        return (self._get(i) for i in range(len(self)))


class _WrittenBack(GatheredList):
    """A :class:`GatheredList` that hands each entry it made to
    ``put(i, entry)`` when the next entry is read and at :meth:`close`:
    what the reader wrote into the entry goes back where it came from."""

    def __init__(self, n: int, get, put):
        super().__init__(n, get)
        self._put, self._open = put, None

    def __getitem__(self, i):
        self.close()
        self._open = (i, self._get(i))
        return self._open[1]

    def close(self) -> None:
        if self._open is not None:
            self._put(*self._open)
            self._open = None


def _map_specs(fn, tree):
    """A spec tree (specs in dataclasses, dicts and lists) with every
    spec ``s`` replaced by ``fn(s)``."""
    if isinstance(tree, sharding.PartitionSpec):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_specs(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return tree


def gathered_state(state, sspec, n_layers: int, mesh, mc):
    """``(view, close)`` for a decode step on the rank's block ``state``
    of a decode state under ``sspec`` (``decode_state_shardings``: the
    K/V sequence split over 'model', or over every axis for a long
    context). ``view`` is ``model.decode_step_``'s state: each layer's
    K/V an ``attention.KVBlock`` (the append writes the rank's rows, the
    core reads the sequence gathered whole), each recurrent state
    gathered whole when the layer reads it and its block written back
    when the read ends (the rank keeps its rows of the batch throughout;
    a stacked leaf whose layer axis the specs split, a recurrent state
    whose heads do not divide over 'model', is gathered over that axis
    once and written back at ``close()``, which the caller runs after the
    step). Lengths and the position are written in place."""
    stacked = not isinstance(state.kv, list) and not isinstance(
        state.rec, list)
    opened = []  # (block, whole, spec) of each leaf gathered at once

    def block_of(spec, shape):
        return sharding.local_slice(spec, tuple(shape), mesh, mc.coords)

    def layers_whole(tree, specs):
        """``tree`` (stacked on a layer axis) with each leaf whose layer
        axis ``specs`` splits gathered over it."""
        whole = []
        for t, spec in zip(leaves(tree), sharding.spec_leaves(specs),
                           strict=True):
            if spec[0] is not None:
                layer_spec = sharding.P(spec[0])
                whole.append(mc.gather(t, layer_spec))
                opened.append((t, whole[-1], layer_spec))
            else:
                whole.append(t)
        return unflatten(tree, whole)

    if stacked:
        state = model.DecodeState(
            kv=None if state.kv is None else layers_whole(state.kv, sspec.kv),
            rec=None if state.rec is None else layers_whole(state.rec,
                                                            sspec.rec),
            position=state.position)

    def layer_specs(tree, i):
        # a leaf's spec without its layer entry (gathered above, where it
        # splits); the batch dim (now dim 0) not gathered: the rank keeps
        # its rows
        if stacked:
            return _map_specs(lambda s: sharding.P(None, *s[2:]), tree)
        return _map_specs(lambda s: sharding.P(None, *s[1:]), tree[i])

    def kv(i):
        st, specs = state.layer_kv(i), layer_specs(sspec.kv, i)
        shape = [n * math.prod(mc.sizes.get(a, 1)
                               for a in sharding._axes_of(e))
                 for n, e in zip(st.k.shape, specs.k)]
        return attention.KVBlock(
            k=st.k, v=st.v, length=st.length,
            start=block_of(specs.k, shape)[1].start,
            gather=lambda t: mc.gather(t, specs.k))

    def rec_pairs(i):
        st, specs = state.layer_rec(i), layer_specs(sspec.rec, i)
        if isinstance(st, torch.Tensor):
            return [(st, specs)], None
        return [(st[key], specs[key]) for key in sorted(st)], sorted(st)

    def rec(i):
        pairs, keys = rec_pairs(i)
        got = [mc.gather(t, spec) for t, spec in pairs]
        return got[0] if keys is None else dict(zip(keys, got))

    def put_rec(i, full):
        pairs, keys = rec_pairs(i)
        fulls = [full] if keys is None else [full[key] for key in keys]
        for (blk, spec), t in zip(pairs, fulls):
            if t is not blk:
                blk.copy_(t[block_of(spec, t.shape)])

    recs = None if state.rec is None else _WrittenBack(n_layers, rec,
                                                        put_rec)

    def close():
        if recs is not None:
            recs.close()
        for blk, t, spec in opened:
            blk.copy_(t[block_of(spec, t.shape)])

    return model.DecodeState(
        kv=None if state.kv is None else GatheredList(n_layers, kv),
        rec=recs, position=state.position), close


def serving_params(cfg, mesh, pspec, *, split: bool = True):
    """``params -> (tree, tp)`` on ``mesh`` (a DeviceMesh): a rank's
    parameter blocks under ``pspec`` as a serving function's ``params``
    (the leaves outside the layers gathered once, each layer's when it is
    read, :class:`GatheredList`) over the data axes and, where 'model'
    does not split the leaf's compute, over 'model'; ``tp`` the rank's
    context for the partitioned program. ``split=False`` gathers every
    leaf whole and gives ``tensor.UNSPLIT`` (the unsplit program)."""
    mc = comm.MeshComm(mesh)
    tp, lands = (split_context(mesh, cfg, pspec) if split
                 else (tensor.UNSPLIT, None))
    specs = list(sharding.spec_leaves(pspec))

    def serving(params):
        tree, hook = mesh_params(params, cfg, specs,
                                 lambda t, spec, key: mc.gather(t, spec),
                                 lands)
        return {**tree, "layers": GatheredList(
            cfg.n_layers, lambda i: hook(i, model.layer_params(tree, i)))}, tp

    return serving


def make_prefill_step(cfg, mesh, *, long_context: bool = False):
    """``(prefill_step, (param_specs, token_spec))``:
    ``prefill_step(params, tokens) -> model.prefill(params, cfg,
    tokens)``. On a DeviceMesh ``params`` are the rank's blocks under
    ``param_specs`` and ``tokens`` its rows; the step runs the
    partitioned program (:func:`serving_params`), its logits whole."""
    pspec = _param_specs(cfg, mesh)
    serving = serving_params(cfg, mesh, pspec) if device_mesh(mesh) \
        else None

    def prefill_step(params, tokens):
        if serving is None:
            return model.prefill(params, cfg, tokens)
        tree, tp = serving(params)
        return model.prefill(tree, cfg, tokens, tp=tp)

    return prefill_step, (pspec, sharding.batch_sharding(mesh))


def device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a DeviceMesh (not a ``sharding.MeshShape``)."""
    return hasattr(mesh, "get_group")


def make_decode_step(cfg, mesh, *, batch: int, seq_len: int,
                     long_context: bool = False):
    """serve_step: one new token against a ``seq_len`` KV cache.
    ``(decode_step, (param_specs, state_specs, token_spec),
    state_shape)``, the state's shape as fake tensors. On a DeviceMesh
    ``params`` are the rank's blocks, ``state`` its block under
    ``state_specs`` and ``token`` its rows: the step runs the partitioned
    program (:func:`serving_params`), each layer's state gathered as it
    reads it (:func:`gathered_state`), and returns the new state as the
    rank's block under the same specs."""
    pspec = _param_specs(cfg, mesh)
    state_shape = sharding.abstract(model.init_decode_state, cfg, batch,
                                    seq_len, device="cpu")
    sspec = sharding.decode_state_shardings(mesh, state_shape, long_context)
    serving = serving_params(cfg, mesh, pspec) if device_mesh(mesh) \
        else None
    mc = comm.MeshComm(mesh) if serving is not None else None

    def decode_step(params, state, token):
        if serving is None:
            return model.decode_step(params, cfg, state, token)
        tree, tp = serving(params)
        new_state = state.fork()
        view, close = gathered_state(new_state, sspec, cfg.n_layers, mesh,
                                     mc)
        logits = model.decode_step_(tree, cfg, view, token, tp=tp)
        close()
        return logits, new_state

    dp = sharding.data_axes(mesh)
    tok_spec = sharding.P(dp if not long_context else None, None)
    return (decode_step, (pspec, sspec, tok_spec), state_shape)
