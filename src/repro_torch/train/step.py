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

The serving wrappers :func:`make_prefill_step` / :func:`make_decode_step`
return their step with the partition specs of
:mod:`repro_torch.parallel.sharding` (over fake-tensor shapes), as the
reference's do for its dry run. ``make_train_step`` does not take a mesh
yet: its ``mesh``/``fsdp`` specs and the data-parallel gradient
reduction are the next slice's.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.utils.deterministic

from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
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


def make_train_step(cfg, *, opt_cfg: adamw.AdamWConfig | None = None,
                    remat: bool = True, microbatch: int = 1):
    """The training step. With ``microbatch > 1`` the batch splits into
    that many equal parts along its rows; their f32 gradients and losses
    are summed in order, then divided by ``microbatch`` (the reference's
    ``lax.scan``, as a loop)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        with deterministic():
            if microbatch > 1:
                tk = tokens.reshape(microbatch, tokens.shape[0] // microbatch,
                                    -1)
                lb = labels.reshape(microbatch, labels.shape[0] // microbatch,
                                    -1)
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                         for p in leaves(params)]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
                for i in range(microbatch):
                    l, g = value_and_grad(params, cfg, tk[i], lb[i],
                                          remat=remat)
                    grads = [a + b.float() for a, b in zip(grads, g)]
                    loss = loss + l
                    del g
                grads = [g / microbatch for g in grads]
                loss = loss / microbatch
            else:
                loss, grads = value_and_grad(params, cfg, tokens, labels,
                                             remat=remat)
            new_params, new_opt = adamw.update_leaves(params, grads,
                                                      opt_state, opt_cfg)
        return new_params, new_opt, dict(loss=loss)

    return train_step


def _param_specs(cfg, mesh):
    return sharding.param_shardings(
        mesh, sharding.abstract(model.init_params, cfg, device="cpu"))


def make_prefill_step(cfg, mesh, *, long_context: bool = False):
    """``(prefill_step, (param_specs, token_spec))``:
    ``prefill_step(params, tokens) -> model.prefill(params, cfg,
    tokens)``."""
    def prefill_step(params, tokens):
        return model.prefill(params, cfg, tokens)

    return prefill_step, (_param_specs(cfg, mesh),
                          sharding.batch_sharding(mesh))


def make_decode_step(cfg, mesh, *, batch: int, seq_len: int,
                     long_context: bool = False):
    """serve_step: one new token against a ``seq_len`` KV cache.
    ``(decode_step, (param_specs, state_specs, token_spec),
    state_shape)``, the state's shape as fake tensors."""
    def decode_step(params, state, token):
        return model.decode_step(params, cfg, state, token)

    state_shape = sharding.abstract(model.init_decode_state, cfg, batch,
                                    seq_len, device="cpu")
    sspec = sharding.decode_state_shardings(mesh, state_shape, long_context)
    dp = sharding.data_axes(mesh)
    tok_spec = sharding.P(dp if not long_context else None, None)
    return (decode_step, (_param_specs(cfg, mesh), sspec, tok_spec),
            state_shape)
