"""Shared helpers of the repro_torch parity tests (``test_torch_*.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import bridge, configs
from repro_torch.serve import ServingBackend

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


def to_jax(tree):
    """A nested dict / list of the port's tensors as JAX arrays, bit for
    bit (bf16 through its 16-bit pattern)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    a = bridge.tensor_to_numpy_bits(tree)
    return jnp.asarray(a.view(jnp.bfloat16) if tree.dtype == torch.bfloat16
                       else a)


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


@dataclasses.dataclass
class SumState:
    """The toy backend's state: the running token sum ``s`` (B,) and a
    ``kv`` leaf (B, width) whose width stands in for page padding."""

    s: torch.Tensor
    kv: torch.Tensor

    def zeros_batch(self, n: int) -> "SumState":
        return SumState(torch.zeros((n,), dtype=self.s.dtype),
                        torch.zeros((n, self.kv.shape[1])))

    def set_row(self, slot: int, row: "SumState") -> None:
        self.s[slot] = row.s[0]
        self.kv[slot] = row.kv[0]


def sum_backend(quantum=None, vocab=32):
    """The port's counterpart of the reference tests' resume-consistent
    ``_sum_backend``: the state carries ``s = sum(tokens consumed)`` and
    every step emits ``one_hot(s % vocab)``; prefill over ``prompt +
    generated`` recomputes the ``s`` the uncontended decode reached.
    ``quantum`` pads the kv width to the prompt-length quantum (page-padded
    signatures), else it is a fixed 8."""

    def prefill_fn(tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32)
        B, S = tokens.shape
        s = tokens.sum(dim=1).to(torch.int32)
        width = 8 if quantum is None else quantum * (
            (S + quantum - 1) // quantum)
        logits = torch.nn.functional.one_hot(s.long() % vocab, vocab)
        return logits.float(), SumState(s, torch.zeros((B, width)))

    def decode_fn(state, token):
        s = state.s + token[:, 0]
        logits = torch.nn.functional.one_hot(s.long() % vocab, vocab)
        return logits.float(), SumState(s, state.kv)

    return ServingBackend(prefill_fn, decode_fn, vocab=vocab, device="cpu")


def jax_sum_backend(quantum=None, vocab=32):
    """The reference tests' ``_sum_backend`` (tests/test_serve_capacity.py),
    the JAX side of :func:`sum_backend`."""
    from repro.serve import ServingBackend as JServingBackend

    def prefill_fn(tokens):
        B, S = tokens.shape
        s = jnp.sum(tokens, axis=1).astype(jnp.int32)
        width = 8 if quantum is None else quantum * (
            (S + quantum - 1) // quantum)
        kv = jnp.zeros((B, width), jnp.float32)
        return jax.nn.one_hot(s % vocab, vocab), dict(s=s, kv=kv)

    def decode_fn(state, token):
        s = state["s"] + token[:, 0]
        return jax.nn.one_hot(s % vocab, vocab), dict(s=s, kv=state["kv"])

    return JServingBackend(prefill_fn, decode_fn, vocab=vocab)


def expected_sum_stream(prompt, n, vocab=32, stop=()):
    """Host replay of the sum backend's greedy stream."""
    s = int(np.sum(prompt))
    out = []
    for _ in range(n):
        tok = s % vocab
        out.append(tok)
        if tok in stop:
            break
        s += tok
    return out
