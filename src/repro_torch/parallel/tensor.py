"""Tensor parallelism over the mesh's 'model' axis: the collectives of
the partitioned layer program, and each rank's view of where 'model'
lands on the parameters it reads.

The reference jits its steps under the parameter shardings and leaves
the split of each product to XLA's SPMD partitioner, which inserts these
collectives itself; the port runs the partitioned program by hand. A
tensor of a layer is either *replicated* (the same bits on every rank of
the 'model' group, its gradient the whole gradient on every rank) or
*local* (the rank's part). The four crossings between them are
``torch.autograd.Function``s:

* :meth:`TP.copy` — replicated in, read by a rank-local product:
  identity forward, the gradient summed over 'model' backward;
* :meth:`TP.sum` — partial products of a split contraction summed:
  sum forward, identity backward;
* :meth:`TP.gather` — the ranks' blocks of a split output concatenated:
  concatenation forward, the rank's slice backward;
* :meth:`TP.scatter` — a replicated tensor cut to the rank's block (the
  input of a split contraction): slice forward, concatenation backward;

and :meth:`TP.max` (no gradient) for a log-sum-exp over split logits.

Every sum is an all-gather of the partials, then an f32 sum in rank
order, then one rounding to the operand's dtype: every rank of a group
holds the same bits of every replicated activation, of the loss and of
every replicated leaf's gradient, so the replicas never drift apart (a
ring all-reduce promises neither the same bits across ranks nor across
runs). On a group of one rank every crossing is the identity and issues
no collective, and every leaf reads as whole (:meth:`TP.land`), so a
one-rank mesh runs the unsplit program's ops; :data:`UNSPLIT` is the
unmeshed callers' context.

Each call counts one ``comm.launches["tp"]`` and its output bytes in
``comm.collective_bytes`` (and in ``comm.tp_bytes``) under the kind it
stands for (``all-reduce`` for a sum, ``all-gather`` for a gather).

Imports torch and the port's ``parallel`` modules only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.parallel import comm, sharding


def _partials(t: torch.Tensor, group) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    comm.launches["tp"] += 1
    return parts


def _count(kind: str, t: torch.Tensor) -> None:
    comm.collective_bytes[kind] += comm._nbytes(t)
    comm.tp_bytes[kind] += comm._nbytes(t)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """``0 + t_0 + t_1 + ...`` in f32 over the group's ranks, in rank
    order, rounded once to ``t``'s dtype."""
    acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    for part in _partials(t, group):
        acc = acc + part.float()
    _count("all-reduce", t)
    return acc.to(t.dtype)


def _cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    out = torch.cat(_partials(t, group), dim)
    _count("all-gather", out)
    return out


def _slice(t: torch.Tensor, dim: int, index: int, size: int):
    """The rank's block of ``t`` along ``dim``: a view, not a copy."""
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.tp.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _sum(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _cat(x, tp.group, dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _slice(g, ctx.dim, tp.index, tp.size), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _slice(x, dim, tp.index, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _cat(g, ctx.tp.group, ctx.dim), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class TP:
    """A rank's place in its 'model' group (``index`` of ``size``; a
    ``group`` of None for one rank) and the :class:`sharding.Landing` of
    each parameter leaf it reads: ``lands`` is a tree like the
    parameters (the leaves of a stacked layer stack without their layer
    axis). :meth:`at` narrows it to a sub-dict, :meth:`land` reads a
    leaf's landing. On a group of one rank every leaf reads as whole, so
    each product runs as one unsplit product."""

    group: object
    size: int
    index: int
    lands: object = None

    # -- the landings ---------------------------------------------------------

    def at(self, key) -> "TP":
        """The context of ``params[key]`` (a dict key or a list index)."""
        if self.one:
            return self
        return dataclasses.replace(self, lands=self.lands[key])

    def land(self, name: str) -> sharding.Landing:
        return WHOLE if self.one else self.lands[name]

    def share(self, name: str) -> int:
        """The divisor of a product of leaf ``name`` on this rank: the
        group's size where the leaf is split, else 1."""
        return self.size if self.land(name).split else 1

    def layer(self, i: int) -> "TP":
        """The context of layer ``i`` of ``params["layers"]`` (a stacked
        stack's layers share one)."""
        if self.one:
            return self
        lands = self.lands["layers"]
        return dataclasses.replace(
            self, lands=lands[i] if isinstance(lands, list) else lands)

    def block(self, n: int) -> tuple[int, int]:
        """``[start, stop)`` of the rank's block of ``n`` items."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} ranks")
        b = n // self.size
        return self.index * b, (self.index + 1) * b

    # -- the crossings --------------------------------------------------------

    @property
    def one(self) -> bool:
        return self.size == 1

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.one else _Copy.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.one else _Sum.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.one else _Gather.apply(x, self, dim % x.ndim)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.one else _Scatter.apply(x, self, dim % x.ndim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group (no gradient)."""
        if self.one:
            return x.detach()
        parts = _partials(x.detach(), self.group)
        _count("all-reduce", x)
        return torch.amax(torch.stack(parts), dim=0)

    def copy_for(self, x: torch.Tensor, *lands):
        """``self.copy(x)`` made once for several products of ``x``, or
        None where no landing among ``lands`` splits an output."""
        if any(land.kind == "output" for land in lands):
            return self.copy(x)
        return None

    def reform(self, x: torch.Tensor, have: int | None,
               want: int | None) -> torch.Tensor:
        """``x`` local along dim ``have`` (None: replicated) made local
        along dim ``want`` (None: replicated)."""
        if have == want:
            return x
        if have is not None:
            x = self.gather(x, have)
        return x if want is None else self.scatter(x, want)

    def full(self, x: torch.Tensor, dim: int | None) -> torch.Tensor:
        """``x`` replicated: gathered along ``dim`` where it is local
        there (``None``: already replicated)."""
        return x if dim is None else self.gather(x, dim)

    # -- products -------------------------------------------------------------

    def linear(self, x, w: torch.Tensor, land: sharding.Landing,
               n_in: int = 1, *, x_dim: int | None = None,
               copied=None) -> tuple[torch.Tensor, int | None]:
        """``x @ w`` contracting ``x``'s last ``n_in`` dims with ``w``'s
        first ``n_in``; ``w`` is the rank's block under ``land``.
        ``x_dim`` (of ``w``'s contracted dims) is where ``x`` is already
        the rank's block (None: ``x`` is replicated); ``copied`` is
        ``self.copy(x)`` where the caller made it once for several
        products. Returns ``(y, y_dim)``: ``y_dim`` the dim of ``y``
        where it is the rank's block (an output split), or None where
        ``y`` is replicated (a whole leaf or a summed contraction)."""
        lead = x.ndim - n_in
        if x_dim is not None and land.dim != x_dim:
            x, x_dim = self.gather(x, lead + x_dim), None
        if land.dim is None:
            return _product(x, w, n_in), None
        if land.kind == "contraction":
            if x_dim is None:
                x = self.scatter(x, lead + land.dim)
            return self.sum(_product(x, w, n_in)), None
        src = copied if copied is not None else self.copy(x)
        y = _product(src, w, n_in)
        return y, lead + land.dim - n_in


#: the landing of a leaf 'model' does not split
WHOLE = sharding.Landing(None, "none")

#: the unsplit program's context: one rank, every leaf whole
UNSPLIT = TP(None, 1, 0)


def _product(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """``x``'s last ``n_in`` dims contracted with ``w``'s first ``n_in``,
    as one product of the flattened operands."""
    k = math.prod(w.shape[:n_in])
    out = w.shape[n_in:]
    y = torch.matmul(x.reshape(*x.shape[:x.ndim - n_in], k),
                     w.reshape(k, math.prod(out)))
    return y.reshape(*x.shape[:x.ndim - n_in], *out)


def context(mesh, params, specs) -> TP:
    """This rank's :class:`TP` on a DeviceMesh for a parameter tree
    ``params`` (global shapes, or fake tensors) under ``specs``; a mesh
    without a 'model' axis is one rank wide over it."""
    size = sharding.mesh_axes(mesh).get("model", 1)
    group = mesh.get_group("model") if size > 1 else None
    index = mesh.get_local_rank("model") if size > 1 else 0
    return TP(group, size, index, sharding.landings(params, specs))


# -- the FLOPs the landings imply ---------------------------------------------


def heads_local(cfg, tp) -> bool:
    """Whether the attention core runs the rank's block of the query
    heads (``tp``: an attention layer's context): the heads divide over
    'model' and ``wq`` splits its heads or ``wo`` its head rows."""
    lq, lo = tp.land("wq"), tp.land("wo")
    return cfg.n_heads % tp.size == 0 and (
        (lq.kind, lq.dim) == ("output", 1)
        or (lo.kind, lo.dim) == ("contraction", 0))


def _core_heads(cfg, tp) -> int:
    return cfg.n_heads // tp.size if heads_local(cfg, tp) else cfg.n_heads


def _proj_flops(cfg, tp, t: int) -> int:
    """The q/k/v and output projections of ``t`` tokens."""
    hd, H, Hkv, d = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    return (2 * t * d * H * hd // tp.share("wq")
            + 2 * 2 * t * d * Hkv * hd // tp.share("wk")
            + 2 * t * H * hd * d // tp.share("wo"))


def _attn_flops(cfg, tp, t: int, b: int, s: int):
    return (_proj_flops(cfg, tp, t)
            + 2 * 2 * b * _core_heads(cfg, tp) * s * s * cfg.head_dim_)


def _swiglu_flops(tp, t: int, d: int, f: int) -> int:
    return sum(2 * t * d * f // tp.share(n)
               for n in ("w_gate", "w_up", "w_down"))


def _moe_flops(cfg, tp, t: int) -> int:
    from repro_torch.models import moe
    e, d = cfg.moe, cfg.d_model
    experts = e.n_experts // tp.share("w_gate")
    out = (2 * t * d * e.n_experts // tp.share("router")
           + 3 * 2 * experts * moe.capacity(t, cfg) * d * e.d_expert)
    if e.n_shared_experts:
        out += _swiglu_flops(tp.at("shared"), t, d,
                             e.d_expert * e.n_shared_experts)
    return out


def _rwkv_flops(cfg, tp, t: int) -> int:
    from repro_torch.models import rwkv
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    heads = rwkv.n_heads(cfg)
    if heads % tp.size == 0:
        heads //= tp.size
    return (sum(2 * t * d * d // tp.share(n)
                for n in ("wr", "wk", "wv", "wg", "w_decay", "wo"))
            + 2 * t * heads * hd * hd  # the scan's state read
            + sum(2 * t * d * cfg.d_ff // tp.share(n) for n in ("ck", "cv")))


def layer_flops(cfg, kind: str, tp, b: int, s: int) -> tuple[int, int]:
    """``(forward, last)``: the forward FLOPs of one layer on a rank
    (``b`` rows of ``s`` tokens; ``tp`` the layer's context), as
    ``FlopCounterMode`` counts them, each product's divided by the
    group's size where its leaf is split (an output or a contraction
    dim) and whole where it is not, the attention core over the rank's
    heads where the core is split; ``last`` those of the layer's last
    product, whose output nothing saves for the backward (a dense FFN's
    down projection: a recompute stops before it)."""
    t, d = b * s, cfg.d_model
    if kind == "attn":
        if cfg.moe:
            ffn = _moe_flops(cfg, tp.at("moe"), t)
            e = cfg.moe
            last = (2 * t * d * e.d_expert * e.n_shared_experts
                    // tp.at("moe").at("shared").share("w_down")
                    if e.n_shared_experts else 0)
        else:
            ffn = _swiglu_flops(tp.at("mlp"), t, d, cfg.d_ff)
            last = 2 * t * d * cfg.d_ff // tp.at("mlp").share("w_down")
        return _attn_flops(cfg, tp.at("attn"), t, b, s) + ffn, last
    if kind == "rec":
        rec = tp.at("rec")
        return (sum(2 * t * d * d // rec.share(n)
                    for n in ("w_x", "w_gate_r", "w_gate_i", "w_out"))
                + _swiglu_flops(tp.at("mlp"), t, d, cfg.d_ff),
                2 * t * d * cfg.d_ff // tp.at("mlp").share("w_down"))
    tm = tp.at("tmix")
    return _rwkv_flops(cfg, tm, t), 2 * t * d * cfg.d_ff // tm.share("cv")


def step_flops(cfg, tp, rows: int, seq_len: int) -> int:
    """The FLOPs of one training step (``lm_loss`` with remat, its
    gradients) on a rank holding ``rows`` rows, as ``FlopCounterMode``
    counts them, from the landings of ``tp`` (:data:`UNSPLIT`: the
    unsplit step): every product reads two operands that take a
    gradient, so it runs once forward and twice backward, and a layer's
    products once more in its recompute but the last
    (:func:`layer_flops`); the embedding lookup counts none."""
    total = 0
    for i, kind in enumerate(cfg.layer_kinds):
        fwd, last = layer_flops(cfg, kind, tp.layer(i), rows, seq_len)
        total += 4 * fwd - last
    head = "embedding" if cfg.tie_embeddings else "lm_head"
    return total + 3 * 2 * rows * seq_len * cfg.d_model * cfg.vocab // (
        tp.share(head))


def sectored_step_flops(cfg, tp, rows: int, tokens: int) -> int:
    """The FLOPs of one sectored decode step on a rank
    (``runtime.sectored_decode.sectored_decode_step_``) holding ``rows``
    rows, as ``FlopCounterMode`` counts them, from the landings of ``tp``
    (:data:`UNSPLIT`: the unsplit step): each layer's projections and FFN
    on ``rows`` tokens, split as :func:`layer_flops` splits them, and its
    attention core over ``tokens`` token slots a query head (the selected
    pages, probe included, times the page size) for the core's heads on
    the rank; the logits forward only. ``tokens=0`` where the core is
    the paged kernel on the card (the fused flavors), which the counter
    does not see."""
    total = 0
    for i in range(cfg.n_layers):
        ltp = tp.layer(i)
        attn = ltp.at("attn")
        total += (_proj_flops(cfg, attn, rows)
                  + 2 * 2 * rows * _core_heads(cfg, attn) * tokens
                  * cfg.head_dim_)
        if cfg.moe:
            total += _moe_flops(cfg, ltp.at("moe"), rows)
        else:
            total += _swiglu_flops(ltp.at("mlp"), rows, cfg.d_model,
                                   cfg.d_ff)
    head = "embedding" if cfg.tie_embeddings else "lm_head"
    return total + 2 * rows * cfg.d_model * cfg.vocab // tp.share(head)
