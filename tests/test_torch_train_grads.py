"""The port's LM loss and its gradients against the JAX reference, for
all ten reduced configs, on the port's parameters bridged to the
reference bit for bit.

* ``lm_loss`` and every gradient against ``jax.value_and_grad`` of the
  reference's ``lm_loss`` (jitted), in f32 (the witness: a real fault
  cannot hide in bf16 noise) and in bf16 (the configs' dtype). Gradient
  errors are per leaf, relative to the leaf's largest magnitude (max)
  and to its norm (norm). Measured over the ten configs: f32 loss
  ≤ 4.8e-7, max ≤ 1.9e-6, norm ≤ 1.5e-6; bf16 loss ≤ 5.8e-4, max
  ≤ 0.046, norm ≤ 0.029 (both qwen3-moe's). Tolerances below.
* remat (``torch.utils.checkpoint`` per layer) gives the loss and every
  gradient bit for bit.
* one AdamW step on a fixed batch does not raise the loss by more than
  0.05 (the reference's ``test_one_train_step``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f32, to_jax
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import bridge, configs
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.runtime.graphs import leaves, map_tree
from repro_torch.train import step as train_step

ARCHS = sorted(configs.ARCHS)
LOSS_TOL = {"float32": 2e-6, "bfloat16": 2e-3}
GRAD_MAX_TOL = {"float32": 1e-5, "bfloat16": 0.08}
GRAD_NORM_TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _batch(vocab, shape=(2, 16), seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's ``init_params`` (seed 0) of the reduced config, bf16."""
    return model.init_params(configs.get(arch).reduced(), seed=0,
                             device="cpu")


def _bridged(arch, dtype):
    """(jax cfg, port cfg, jax params, port params) in ``dtype``, the
    same values bit for bit on both sides; the f32 witness holds the bf16
    draws cast to f32."""
    jcfg = jconfigs.get(arch).reduced(dtype=dtype)
    cfg = configs.get(arch).reduced(dtype=dtype)
    params = _port_params(arch)
    if dtype == "float32":
        params = map_tree(lambda t: t.float(), params)
    return jcfg, cfg, to_jax(params), params


def bits(t):
    return bridge.tensor_to_numpy_bits(t.reshape(-1)).view(
        np.uint16 if t.dtype == torch.bfloat16 else np.uint8)


def grad_errors(ref_leaves, port_leaves):
    """Largest per-leaf error relative to the leaf's max magnitude, and
    relative to its norm."""
    worst_max = worst_norm = 0.0
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        a, b = f32(a), f32(b)
        assert a.shape == b.shape
        d = np.abs(a - b)
        worst_max = max(worst_max, float(d.max() / max(np.abs(a).max(),
                                                       1e-30)))
        worst_norm = max(worst_norm, float(np.linalg.norm(d)
                                           / max(np.linalg.norm(a), 1e-30)))
    return worst_max, worst_norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, dtype):
    jcfg, cfg, jparams, params = _bridged(arch, dtype)
    toks, labels = _batch(cfg.vocab)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.lm_loss(p, jcfg, toks, labels)))(jparams)
    loss, grads = train_step.value_and_grad(
        params, cfg, torch.from_numpy(toks), torch.from_numpy(labels))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL[dtype]
    jl = jax.tree.leaves(jgrads)
    for a, b in zip(jl, grads):
        assert b.dtype == getattr(torch, str(a.dtype))
    worst_max, worst_norm = grad_errors(jl, grads)
    assert worst_max <= GRAD_MAX_TOL[dtype], worst_max
    assert worst_norm <= GRAD_NORM_TOL[dtype], worst_norm


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise(arch):
    cfg = configs.get(arch).reduced()
    params = model.init_params(cfg, seed=1, device="cpu")
    toks, labels = (torch.from_numpy(a) for a in _batch(cfg.vocab))
    loss0, g0 = train_step.value_and_grad(params, cfg, toks, labels)
    loss1, g1 = train_step.value_and_grad(params, cfg, toks, labels,
                                          remat=True)
    np.testing.assert_array_equal(bits(loss0), bits(loss1))
    for a, b in zip(g0, g1, strict=True):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """The reference's ``test_one_train_step`` on the port: finite losses,
    and one AdamW step on the same batch does not raise the loss by more
    than 0.05."""
    cfg = configs.get(arch).reduced()
    params = model.init_params(cfg, seed=0, device="cpu")
    ocfg = adamw.AdamWConfig(lr=1e-3)
    opt = adamw.init_state(params, ocfg)
    toks = torch.from_numpy(_batch(cfg.vocab)[0])
    step, _, _ = train_step.make_train_step(cfg, opt_cfg=ocfg, remat=False)
    new_params, new_opt, m = step(params, opt, dict(tokens=toks,
                                                    labels=toks))
    l0 = float(m["loss"])
    l1 = float(model.lm_loss(new_params, cfg, toks, toks))
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0 + 0.05
    assert int(new_opt["step"]) == 1 and int(opt["step"]) == 0
    assert not any(p.requires_grad or p.grad is not None
                   for p in leaves(new_params))
