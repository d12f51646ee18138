"""AdamW with optional low-precision moments and int8 error-feedback
gradient compression (counterpart of the JAX package's
``optim/adamw.py``).

Plain functions over the nested dict of parameter tensors, as in the
reference; the state is ``dict(mu, nu, step[, ef])``, trees shaped like
the parameters. The update is elementwise, so it runs over each leaf in
chunks of at most ``CHUNK`` elements along the leaf's leading (layer)
axis: the f32 temporaries of a stacked ``(L, ...)`` leaf stay one chunk
big, and the bits are those of the whole-leaf update. Every f32 constant
enters as the reference's does (a Python float rounded to f32 in the
op), a scalar divided by a tensor is a true division (Python's ``x / t``
on a tensor multiplies by a reciprocal) and the square root is the
correctly rounded one (:func:`_sqrt`), so on the CPU the unclipped
update and the int8 round trip equal the reference's bit for bit. The
global gradient norm sums in another order, so a clipped update agrees
within a tolerance.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime.graphs import leaves, map_tree, unflatten

#: elements of one chunk of the elementwise update (256 MiB of f32)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # moment dtype: float32, or bfloat16 to halve the optimizer's memory
    moment_dtype: str = "float32"
    grad_clip: float = 1.0
    # int8 error-feedback compression of the gradients
    compress_grads: bool = False


def init_state(params, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)
    first = next(leaves(params))
    state = dict(
        mu=map_tree(lambda p: torch.zeros(p.shape, dtype=mdt,
                                          device=p.device), params),
        nu=map_tree(lambda p: torch.zeros(p.shape, dtype=mdt,
                                          device=p.device), params),
        step=torch.zeros((), dtype=torch.int32, device=first.device))
    if cfg.compress_grads:
        state["ef"] = map_tree(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params)
    return state


def _chunks(t: torch.Tensor):
    """Index objects that cover ``t`` in pieces of at most CHUNK elements
    along its leading axis (the whole of a small or 0-dim tensor)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        yield ...
        return
    rows = max(1, CHUNK // max(1, t[0].numel()))
    for start in range(0, t.shape[0], rows):
        yield slice(start, start + rows)


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's: taken in f64 and
    rounded once to f32 (which is exact for sqrt). torch's f32 ``sqrt``
    on the CPU is vectorized through an approximation that misses it by
    an ulp on about 0.6 % of inputs."""
    return torch.sqrt(x.double()).float()


def _compress_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization."""
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _absmax(g: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """max |g + ef| in f32, chunk by chunk (exact)."""
    absmax = torch.zeros((), dtype=torch.float32, device=g.device)
    for c in _chunks(g):
        g32 = g[c].float() + ef[c].float()
        absmax = torch.maximum(absmax, torch.max(torch.abs(g32)))
    return absmax


def compress_roundtrip(g: torch.Tensor, ef: torch.Tensor,
                       absmax: torch.Tensor | None = None):
    """Error-feedback int8 round trip: returns ``(g_hat, new_ef)``, g_hat
    in ``g``'s dtype and the new error in bf16. Chunked: the scale is the
    exact max over every chunk, then each chunk is quantized with it.
    ``absmax`` (the max over the whole leaf, where ``g`` is one rank's
    block of it) replaces the block's own."""
    if absmax is None:
        absmax = _absmax(g, ef)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    g_hat = torch.empty_like(g)
    new_ef = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    for c in _chunks(g):
        g32 = g[c].float() + ef[c].float()
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        dq = _decompress_int8(q, scale)
        g_hat[c] = dq.to(g.dtype)
        new_ef[c] = (g32 - dq).to(torch.bfloat16)
    return g_hat, new_ef


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(g[c].float())) for c in _chunks(g))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares (leaf by leaf, in
    :func:`leaves` order)."""
    total = None
    for g in grads:
        s = _sum_squares(g)
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply_updates(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step. Returns ``(new_params, new_state)``; the inputs
    are left as they were."""
    return update_leaves(params, list(leaves(grads)), state, cfg)


def update_leaves(params, grads: list, state: dict, cfg: AdamWConfig, *,
                  mesh_comm=None, specs: list | None = None):
    """:func:`apply_updates` over ``grads`` given as a list in
    :func:`leaves` order. The list is consumed: each entry is dropped
    once its leaf is updated, so a caller that holds no other reference
    frees the gradients as the new state grows.

    With ``mesh_comm`` (a :class:`~repro_torch.parallel.comm.MeshComm`)
    every leaf of ``params``, ``grads`` and the state is this rank's
    block under its spec in ``specs``, and the update is the unsharded
    one's block: the elementwise part is, the int8 scale of a leaf is the
    max over every rank (exact), and the global norm sums each leaf's
    squares over the ranks holding its distinct blocks (another order
    than the unsharded sum where a leaf is split). Under the partitioned
    program a leaf split over 'model' gets its gradient as the rank's
    block, the block it stores, so each distinct block still counts
    once."""
    params_l = list(leaves(params))
    if len(grads) != len(params_l):
        raise ValueError(f"{len(grads)} gradients for {len(params_l)} "
                         f"parameters")
    dev = params_l[0].device
    step = state["step"] + 1
    new_ef = None
    if cfg.compress_grads:
        efs = list(leaves(state["ef"]))
        absmax = [None] * len(efs)
        if mesh_comm is not None:
            absmax = list(mesh_comm.max_over_ranks(torch.stack(
                [_absmax(g, ef) for g, ef in zip(grads, efs)])))
        new_ef = []
        for i, ef in enumerate(efs):
            grads[i], e = compress_roundtrip(grads[i], ef, absmax[i])
            new_ef.append(e)
    if mesh_comm is None:
        gnorm = global_norm(grads)
    else:
        gnorm = torch.sqrt(mesh_comm.sum_of_shards(
            [_sum_squares(g) for g in grads], specs))
    scale = torch.clamp_max(
        _f32(cfg.grad_clip, dev) / torch.clamp_min(gnorm, 1e-12), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(_f32(b1, dev), step.float())
    c2 = 1.0 - torch.pow(_f32(b2, dev), step.float())
    mdt = getattr(torch, cfg.moment_dtype)

    new_p, new_m, new_v = [], [], []
    for i, (p, m, v) in enumerate(zip(params_l, leaves(state["mu"]),
                                      leaves(state["nu"]), strict=True)):
        g_leaf = grads[i]
        grads[i] = None
        p2 = torch.empty_like(p)
        m2 = torch.empty(m.shape, dtype=mdt, device=m.device)
        v2 = torch.empty(v.shape, dtype=mdt, device=v.device)
        for c in _chunks(p):
            g = g_leaf[c].float() * scale
            m32 = b1 * m[c].float() + (1 - b1) * g
            v32 = b2 * v[c].float() + (1 - b2) * torch.square(g)
            mhat = m32 / c1
            vhat = v32 / c2
            p32 = p[c].float()
            delta = (mhat / (_sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p32)
            p2[c] = (p32 - cfg.lr * delta).to(p.dtype)
            m2[c] = m32.to(mdt)
            v2[c] = v32.to(mdt)
        del g_leaf
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    new_state = dict(mu=unflatten(state["mu"], new_m),
                     nu=unflatten(state["nu"], new_v), step=step)
    if new_ef is not None:
        new_state["ef"] = unflatten(state["ef"], new_ef)
    return unflatten(params, new_p), new_state


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warmup to ``base_lr``, then a cosine to 0 at
    ``total`` (f32, as the reference computes it)."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(torch.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr
