"""Sharding rules: parameter and state partition specs per architecture
(counterpart of the JAX package's ``parallel/sharding.py``).

Mesh axes:
  * ``pod``   — inter-pod pure data parallelism (multi-pod mesh only)
  * ``data``  — data parallel; with ``fsdp=True`` also shards parameter and
                optimizer-state rows (ZeRO-3 style)
  * ``model`` — tensor parallel: attention heads / FFN columns / experts /
                vocab; for decode, the KV-cache sequence axis

The rules are name-based over the port's parameter dicts and state
dataclasses (the last dict key or field name on a leaf's path), so one
code path covers every architecture; stacked layer parameters get a
leading replicated (layer) axis automatically.

A spec is this module's :class:`PartitionSpec`, a tuple with one entry
per leading dim: ``None`` (replicated), an axis name, or a tuple of axis
names. A mesh is anything that answers its axis names and shape: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``), or an object with ``axis_names`` and ``devices.shape`` or
``shape`` (:class:`MeshShape`, for rules computed without ranks).

The state rules take the port's layouts. The reference stacks a serving
wave's per-slot states on a new leading slot axis; the port's wave buffer
is one state whose batch axis is the slot axis (axis 1 of a layer-stacked
leaf, axis 0 of ``position`` and of a hybrid's per-layer leaves), so
:func:`wave_state_shardings` places the data axes on each leaf's batch
axis. Every spec equals the reference's once its leaf is moved into the
port's layout (the singleton batch axis of a reference row dropped).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


class PartitionSpec(tuple):
    """Per-dim placement: ``None``, an axis name, or a tuple of names;
    dims past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as the rules see it: axis names and sizes, no ranks."""

    shape: tuple
    axis_names: tuple


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a DeviceMesh, a :class:`MeshShape` or any
    object with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else mesh.shape
    return dict(zip(tuple(names), tuple(shape)))


def data_axes(mesh) -> tuple:
    """The pure-DP axes present in this mesh ('pod' only on multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def abstract(fn: Callable, *args, **kwargs):
    """``fn``'s result with fake tensors (shapes and dtypes, no storage):
    the port's ``jax.eval_shape``, for rules over full-size trees."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn(*args, **kwargs)


# -- named tree walks ---------------------------------------------------------


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "ndim")


def map_named(fn: Callable, tree, name: str = ""):
    """``tree`` (dicts, lists, tuples, dataclasses) with every leaf ``t``
    replaced by ``fn(name, t)``, ``name`` its last key or field (a list
    index reads ``[i]``, as a JAX key path's last entry does)."""
    if _is_leaf(tree):
        return fn(name, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_named(fn, getattr(tree, f.name), f.name)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        # visited in sorted-key order, as ``runtime.graphs.leaves`` walks
        out = {k: map_named(fn, tree[k], str(k)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_named(fn, v, f"[{i}]")
                          for i, v in enumerate(tree))
    return tree


def slot_leaves(state) -> list[tuple[str, Any, int]]:
    """``(name, leaf, batch axis)`` of a decode state's tensors, in the
    order ``runtime.graphs.leaves`` gives them. The state says where its
    batch axis lies through ``_parts()`` (``(subtree, axis)`` pairs)."""
    out: list = []
    for part, axis in state._parts():
        map_named(lambda name, t, a=axis: out.append((name, t, a)), part,
                  _part_name(state, part))
    return out


def _part_name(state, part) -> str:
    for f in dataclasses.fields(state):
        if getattr(state, f.name) is part:
            return f.name
    return ""


# -- the rules ----------------------------------------------------------------


def param_spec(name: str, leaf, fsdp_axis) -> PartitionSpec:
    """The rule for one parameter leaf by its name (the reference's
    table), padded with leading replicated axes for stacked layers."""
    f = fsdp_axis  # None or "data"
    table = {
        # embeddings
        "embedding": P("model", f),
        "lm_head": P("model", f),
        # attention
        "wq": P(f, "model", None),
        "wk": P(f, "model", None),
        "wv": P(f, "model", None),
        "wo": P("model", None, f),
        "bq": P("model", None),
        "bk": P("model", None),
        "bv": P("model", None),
        # dense mlp
        "w_gate": P(f, "model"),
        "w_up": P(f, "model"),
        "w_down": P("model", f),
        # rwkv time/channel mix
        "wr": P(f, "model"),
        "wg": P(f, "model"),
        "w_decay": P(f, "model"),
        "ck": P(f, "model"),
        "cv": P("model", f),
        "u": P("model", None),
        # rg-lru
        "w_x": P(f, "model"),
        "w_gate_r": P(f, "model"),
        "w_gate_i": P(f, "model"),
        "w_out": P("model", f),
        # moe router
        "router": P(None, "model"),
    }
    # MoE expert tensors share names with the dense MLP but are 3-D
    if name in ("w_gate", "w_up", "w_down") and leaf.ndim >= 3:
        spec = P("model", f, None) if name != "w_down" else P("model", None, f)
    elif name in table:
        spec = table[name]
    else:
        spec = P()  # norms, scalars, biases -> replicated
    # stacked-layer leading axis (param rank exceeds the rule rank)
    pad = leaf.ndim - len(spec)
    if pad > 0:
        spec = P(*((None,) * pad + tuple(spec)))
    elif pad < 0:
        spec = P(*(tuple(spec)[-leaf.ndim:] if leaf.ndim else ()))
    return spec


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> list:
    """Every axis name a spec mentions, flattened."""
    return [a for entry in spec for a in _axes_of(entry)]


def drop_indivisible(spec, shape, mesh) -> tuple[PartitionSpec, list]:
    """Drop axes from dims they do not divide; NO re-placement.

    Returns ``(fixed_spec, dropped_axes)``. A dropped axis degrades that
    dim to replicated and nothing else changes: callers with a placement
    contract to keep (:func:`wave_state_shardings`' gather-only 'model'
    shard) use this directly, so an indivisible axis is never re-homed
    onto a contraction dim behind their back.
    """
    sizes = mesh_axes(mesh)
    entries = (list(spec) + [None] * (len(shape) - len(spec)))[: len(shape)]
    dropped = []
    for i, entry in enumerate(entries):
        ax = _axes_of(entry)
        prod = 1
        for a in ax:
            prod *= sizes.get(a, 1)
        if ax and shape[i] % prod != 0:
            dropped.extend(ax)
            entries[i] = None
    return P(*entries), dropped


def fix_spec(spec, shape, mesh) -> PartitionSpec:
    """Make a spec divisibility-valid for this mesh.

    Indivisible axes are dropped (:func:`drop_indivisible`); a dropped
    'model' axis is re-placed on the first unassigned dim it divides
    (moving tensor parallelism to a contraction dim: the GQA case of
    fewer kv heads than the model degree).
    """
    sizes = mesh_axes(mesh)
    fixed, dropped = drop_indivisible(spec, shape, mesh)
    entries = list(fixed)
    for a in dropped:
        if a != "model":
            continue
        for i, entry in enumerate(entries):
            if (entry is None and shape[i] % sizes["model"] == 0
                    and shape[i] >= sizes["model"]):
                entries[i] = "model"
                break
    return P(*entries)


def param_shardings(mesh, params, fsdp: bool = False):
    """Spec tree for a parameter tree (tensors or fake tensors from
    :func:`abstract`). On a mesh without a 'model' axis (a training mesh
    ``'d'``) the specs still name it, as one rank wide."""
    f = "data" if (fsdp and "data" in mesh_axes(mesh)) else None
    return map_named(
        lambda name, leaf: fix_spec(param_spec(name, leaf, f),
                                    tuple(leaf.shape), mesh), params)


def batch_sharding(mesh) -> PartitionSpec:
    """(B, S) token batches: batch over all DP axes."""
    return P(data_axes(mesh), None)


def sectored_state_shardings(mesh, state, long_context: bool = False):
    """Spec tree for a ``SectoredState`` (kv leaves ``(L, B, S, Hkv,
    hd)``, ``length`` ``(L, B)``, ``table`` ``(L, B, Hkv, P)``,
    ``position`` ``(B,)``): batch over the DP axes, the KV sequence over
    'model' (over every axis for ``long_context``)."""
    dp = data_axes(mesh)

    def one(name, leaf):
        if name in ("k", "v"):
            if long_context:
                spec = P(None, None, tuple(dp) + ("model",), None, None)
            else:
                spec = P(None, dp, "model", None, None)
        elif name == "table":
            spec = P(None, dp if not long_context else None, None, None)
        elif name == "position":
            spec = P(dp if not long_context else None)
        elif name == "length":
            spec = P(None, dp if not long_context else None)
        else:
            spec = P()
        return fix_spec(spec, tuple(leaf.shape), mesh)

    return map_named(one, state)


def wave_state_shardings(mesh, state, *, shard_pages: bool = True) -> list:
    """Specs for a serving wave buffer, one per leaf in
    ``runtime.graphs.leaves`` order.

    The slot axis (each leaf's batch axis) shards over the DP axes; with
    ``shard_pages`` the KV leaves also spread their page/sequence axis
    (third-from-last: ``(..., S_pad, Hkv, hd)``) over 'model', which only
    a gather-based attend may allow (a dense attend contracting over a
    sharded sequence would reorder float sums). Divisibility is repaired
    per leaf by :func:`drop_indivisible` only: an indivisible slot or
    page axis degrades to replicated and is never re-homed.
    """
    dp = data_axes(mesh)
    model = "model" if "model" in mesh_axes(mesh) else None
    specs = []
    for name, leaf, axis in slot_leaves(state):
        entries = [None] * leaf.ndim
        entries[axis] = dp
        if name in ("k", "v") and shard_pages and model and leaf.ndim >= 3:
            entries[leaf.ndim - 3] = model
        specs.append(drop_indivisible(P(*entries), tuple(leaf.shape),
                                      mesh)[0])
    return specs


def wave_token_sharding(mesh, shape=None) -> PartitionSpec:
    """(slots, 1, 1) wave token batches: slot axis over the DP axes. With
    the concrete ``shape`` an indivisible slot axis degrades to
    replicated, as the state leaves do."""
    spec = P(data_axes(mesh), None, None)
    if shape is not None:
        spec, _ = drop_indivisible(spec, shape, mesh)
    return spec


def decode_state_shardings(mesh, state, long_context: bool):
    """Spec tree for a ``DecodeState``: batch over the DP axes, the KV
    sequence over 'model' (over every axis for ``long_context``, when the
    batch is too small to shard)."""
    dp = data_axes(mesh)

    def one(name, leaf):
        if name in ("k", "v"):
            # stacked: (L, B, S, Hkv, hd) or per-layer (B, S, Hkv, hd)
            if long_context:
                spec = P(*((None,) * (leaf.ndim - 4)), None,
                         tuple(dp) + ("model",), None, None)
            else:
                spec = P(*((None,) * (leaf.ndim - 4)), dp, "model", None,
                         None)
        elif name == "S":  # rwkv state (L, B, h, hd, hd)
            spec = P(*((None,) * (leaf.ndim - 4)), dp, "model", None, None)
        elif name in ("length", "position"):
            spec = P(*((None,) * (leaf.ndim - 1)),
                     dp if not long_context else None)
        elif leaf.ndim >= 2:
            spec = P(*((None,) * (leaf.ndim - 2)),
                     dp if not long_context else None, None)
        else:
            spec = P()
        return fix_spec(spec, tuple(leaf.shape), mesh)

    return map_named(one, state)


# -- applying a spec ----------------------------------------------------------


def spec_leaves(tree):
    """The specs of a spec tree, in ``runtime.graphs.leaves`` order (dict
    keys sorted; a spec is a leaf, not a tuple to walk)."""
    if isinstance(tree, PartitionSpec):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from spec_leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from spec_leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from spec_leaves(item)


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's index along each axis of a DeviceMesh."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def local_slice(spec, shape, mesh, coords: dict[str, int]) -> tuple:
    """The index (a tuple of slices) of one rank's block of a global
    array of ``shape`` under ``spec``; ``coords`` maps each axis to the
    rank's index along it. A dim split over several axes is split over
    them in order, the first one outermost (as a named sharding does).
    An axis the mesh lacks is one rank wide."""
    sizes = mesh_axes(mesh)
    index = []
    for i, n in enumerate(shape):
        ax = _axes_of(spec[i] if i < len(spec) else None)
        parts, pos = 1, 0
        for a in ax:
            pos = pos * sizes.get(a, 1) + coords.get(a, 0)
            parts *= sizes.get(a, 1)
        block = n // parts
        index.append(slice(pos * block, (pos + 1) * block))
    return tuple(index)


def block_index(spec, shape, mesh, coords: dict[str, int],
                dim: int) -> tuple[int, int]:
    """``(index, count)`` of one rank's block along ``dim`` of a global
    array of ``shape`` under ``spec`` (:func:`local_slice`)."""
    sl = local_slice(spec, shape, mesh, coords)[dim]
    block = sl.stop - sl.start
    return sl.start // block, shape[dim] // block


def opt_state_shardings(param_specs, opt_cfg) -> dict:
    """The optimizer state's spec tree, as the reference's
    ``train/step.py`` builds it: ``mu`` and ``nu`` (and ``ef`` with
    ``compress_grads``) under the parameters' specs, ``step``
    replicated."""
    out = dict(mu=param_specs, nu=param_specs, step=P())
    if opt_cfg.compress_grads:
        out["ef"] = param_specs
    return out


def place(tree, specs, mesh, coords: dict | None = None):
    """``tree`` (global tensors) with every leaf cut to this rank's block
    under the spec tree ``specs``; a block that is part of its leaf is a
    copy, a whole leaf is kept as it is."""
    from repro_torch.runtime.graphs import leaves, unflatten
    coords = coords if coords is not None else mesh_coords(mesh)
    blocks = []
    for t, spec in zip(leaves(tree), spec_leaves(specs), strict=True):
        block = t[local_slice(spec, tuple(t.shape), mesh, coords)]
        blocks.append(block.clone() if block.numel() != t.numel() else t)
    return unflatten(tree, blocks)


# -- where 'model' lands ------------------------------------------------------

#: the dims of a leaf (as a layer reads it, its layer axis dropped) that a
#: product contracts over: ``x @ w`` reads dim 0 (the attention ``wo``
#: dims 0 and 1; an expert tensor ``(E, in, out)`` dim 1; ``lm_head``,
#: read as ``x @ w.T``, dim 1). The ``embedding`` is a lookup: both its
#: dims are outputs (a tied one's unembedding contracts its dim 1)
CONTRACTED = {
    "wo": (0,), "wq": (0,), "wk": (0,), "wv": (0,), "wr": (0,), "wg": (0,),
    "w_decay": (0,), "ck": (0,), "cv": (0,), "w_x": (0,), "w_gate_r": (0,),
    "w_gate_i": (0,), "w_out": (0,), "w_gate": (0,), "w_up": (0,),
    "w_down": (0,), "router": (0,), "lm_head": (1,),
}


@dataclasses.dataclass(frozen=True)
class Landing:
    """Where 'model' lands on a leaf as a layer reads it: ``dim`` (None
    when the leaf is whole: 'model' is absent or on its layer axis) and
    ``kind``, ``"none"``, ``"layer"``, ``"output"`` or ``"contraction"``."""

    dim: int | None
    kind: str

    @property
    def split(self) -> bool:
        return self.dim is not None


def landing(name: str, spec, ndim: int, stacked: bool) -> Landing:
    """The :class:`Landing` of one parameter leaf of ``ndim`` dims (the
    stored leaf, a stacked one with its layer axis) under its fixed
    ``spec``."""
    entries = list(spec) + [None] * (ndim - len(spec))
    if stacked:
        if "model" in _axes_of(entries[0]):
            return Landing(None, "layer")
        entries = entries[1:]
    dims = [i for i, e in enumerate(entries) if "model" in _axes_of(e)]
    if not dims:
        return Landing(None, "none")
    dim = dims[0]
    if name == "wo" and len(entries) == 3:
        contracted = (0, 1)
    elif name in ("w_gate", "w_up", "w_down") and len(entries) == 3:
        contracted = (1,)
    else:
        contracted = CONTRACTED.get(name, ())
    return Landing(dim, "contraction" if dim in contracted else "output")


def landings(params, specs):
    """A tree like ``params`` (a dict of tensors or fake tensors, the
    reference's layout) with each leaf's :class:`Landing` under the spec
    tree ``specs``; the leaves under ``params["layers"]`` carry a layer
    axis where the layers are stacked."""
    stacked = not isinstance(params["layers"], list)
    out = {}
    for key in params:
        it = iter(spec_leaves(specs[key]))
        out[key] = map_named(
            lambda name, t, k=key: landing(name, next(it), t.ndim,
                                           stacked and k == "layers"),
            params[key], key)
    return out


def landing_leaves(tree) -> list:
    """The :class:`Landing` s of a landing tree, in ``leaves`` order."""
    if isinstance(tree, Landing):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in landing_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in landing_leaves(item)]
    return []
