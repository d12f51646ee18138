"""repro_torch sector predictor vs the JAX reference: page selections are
integers and must match exactly, ties included (``lax.top_k`` breaks them
toward the lower index; the port's stable sort must agree)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.runtime import sector_predictor as jsp
from repro_torch.runtime import sector_predictor as sp

PAGE = 128


def _both(table, position, k, probe=None):
    want = np.asarray(jsp.predict_topk(
        jnp.asarray(table), jnp.asarray(position), PAGE, k,
        probe_page=None if probe is None else jnp.asarray(probe)))
    got = sp.predict_topk(
        torch.from_numpy(table), torch.from_numpy(position), PAGE, k,
        probe_page=None if probe is None else torch.from_numpy(probe))
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("k", [1, 3, 5, 8, 64])
def test_predict_topk_zero_table_ties(k):
    """A fresh (all-zero) table: every valid page ties, and with k above
    the valid pages every invalid page ties at -inf."""
    table = np.zeros((3, 2, 64), np.float32)
    position = np.array([0, 130, 6000], np.int32)
    want, got = _both(table, position, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_predict_topk_random_with_probe(seed):
    rng = np.random.default_rng(seed)
    P = 24
    table = rng.random((4, 3, P)).astype(np.float32)
    table[:, :, ::5] = 0.25  # planted ties among history scores
    position = rng.integers(0, P * PAGE, 4).astype(np.int32)
    position[0] = 700  # 6 valid pages: k + 1 = 7 exceeds them
    probe = np.array(jsp.probe_page_for(jnp.asarray(position), PAGE))
    for k in (2, 4, 7):
        want, got = _both(table, position, k, probe)
        np.testing.assert_array_equal(got, want)
        assert (np.diff(got, axis=-1) > 0).all()  # ascending, distinct


def test_torch_topk_would_break_ties_differently():
    """Why the port sorts: on a zero table with one bonus page, the
    reference takes the lowest tied indices."""
    table = np.zeros((1, 1, 50), np.float32)
    position = np.array([49 * PAGE], np.int32)
    want, got = _both(table, position, 5)
    assert want.tolist() == [[[0, 1, 2, 3, 49]]]
    np.testing.assert_array_equal(got, want)


def test_probe_page_for_matches():
    position = np.arange(0, 5 * PAGE, 7, dtype=np.int32)
    np.testing.assert_array_equal(
        sp.probe_page_for(torch.from_numpy(position), PAGE).numpy(),
        np.asarray(jsp.probe_page_for(jnp.asarray(position), PAGE)))


def test_update_matches():
    rng = np.random.default_rng(5)
    table = rng.random((3, 2, 10)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(10, 4, replace=False))
                    for _ in range(6)]).reshape(3, 2, 4).astype(np.int32)
    mass = rng.random((3, 2, 4)).astype(np.float32)
    want = np.asarray(jsp.update(jnp.asarray(table), jnp.asarray(idx),
                                 jnp.asarray(mass)))
    got = sp.update(torch.from_numpy(table), torch.from_numpy(idx),
                    torch.from_numpy(mass)).numpy()
    # same f32 operations on distinct indices; measured max-abs-err 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("gids", [[0, 1, 2, 0], [0, 0, 0, 0], [3, 1, 1, 3],
                                  [0, 1, 2, 3]])
def test_pool_demands_matches(gids):
    rng = np.random.default_rng(6)
    table = rng.random((4, 2, 3, 8)).astype(np.float32)
    want = np.asarray(jsp.pool_demands(jnp.asarray(table), np.asarray(gids)))
    got = sp.pool_demands(torch.from_numpy(table), np.asarray(gids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gids", [[0, 1, 4, 0], [-1, 0, 0, 0]])
def test_pool_demands_rejects_out_of_range(gids):
    table = torch.zeros((4, 2, 3, 8))
    with pytest.raises(ValueError, match="group_ids"):
        sp.pool_demands(table, np.asarray(gids))
    with pytest.raises(ValueError, match="group_ids"):
        jsp.pool_demands(jnp.zeros((4, 2, 3, 8)), np.asarray(gids))
