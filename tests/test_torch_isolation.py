"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro`` (the machine with the GPU
has no JAX), and the parameter bridge the parity tests rely on carries
bf16 bit for bit."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import bridge

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_the_whole_port():
    assert len(PORT_FILES) > 20
    assert "repro_torch" in _imported_roots(ROOT / "chip_smoke.py")


def test_bridge_roundtrips_bf16_bitwise():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(size=497) * 10.0 ** rng.integers(
        -30, 30, 497), [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 3e38]])
    a = np.asarray(jnp.asarray(vals.reshape(-1, 7), jnp.bfloat16))
    assert a.dtype.name == "bfloat16" and a.dtype.itemsize == 2
    t = bridge.tensor_from_numpy(a, device="cpu")
    assert t.dtype.is_floating_point and t.element_size() == 2
    np.testing.assert_array_equal(bridge.tensor_to_numpy_bits(t),
                                  a.view(np.uint16))


@pytest.mark.parametrize("convert", [
    lambda: bridge.tensor_from_numpy(np.zeros(3, np.float32)),
    lambda: bridge.params_from_numpy({"a": [np.zeros(2, np.int32)]}),
], ids=["tensor", "params"])
def test_bridge_defaults_to_the_gpu(monkeypatch, convert):
    """``device=None`` means the card, as at every entry point: without
    one it raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        convert()


def test_bridge_keeps_tree_and_other_dtypes():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.linspace(0, 1, 5, dtype=np.float32)},
            "d": [np.asarray(jnp.ones((2,), jnp.bfloat16))]}
    out = bridge.params_from_numpy(tree, device="cpu")
    assert set(out) == {"a", "b", "d"} and set(out["b"]) == {"c"}
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(out["b"]["c"].numpy(), tree["b"]["c"])
    assert out["d"][0].tolist() == [1.0, 1.0]
