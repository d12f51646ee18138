"""Shared helpers of the repro_torch parity tests (``test_torch_*.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import bridge, configs

#: the reduced yi-6b of tests/test_kernels_fused.py
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=128, head_dim=32)


def f32(x) -> np.ndarray:
    """A torch tensor or JAX array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)
    return j, bridge.tensor_from_numpy(np.asarray(j), device="cpu")


def small_models():
    """(jax cfg, port cfg, jax params, port params): the reference's
    ``init_params(key 0)`` bridged bit for bit."""
    jcfg = jconfigs.get("yi-6b").reduced(**SMALL)
    cfg = configs.get("yi-6b").reduced(**SMALL)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The parity tests run many tiny CPU ops, which one torch thread
    runs faster than eight (and without contending with other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
