"""Shared helpers of the DRAM-simulator parity tests (``test_torch_sim_*``).

The reference seeds each trace with ``hash(profile.name)``, which Python
randomizes per process, so its traces (and every table built on them)
change from run to run. ``salted_reference`` makes the reference seed its
traces with the port's stable ``name_salt`` instead: the name ``hash`` in
the reference's ``data/traces.py`` module is looked up before the builtin.
The reference's ``run_system`` memo is keyed on workload names, not on the
traces, so it is emptied around every use of the patch.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest

from repro.core import simulator as jsim
from repro.data import traces as jtraces
from repro_torch.core import simulator as psim
from repro_torch.data import traces as ptraces


@contextlib.contextmanager
def salted():
    """The reference seeds its traces as the port does, with both memos
    empty on entry and on exit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraces, "hash", ptraces.name_salt, raising=False)
        jsim._cached_run.cache_clear()
        psim.cache_clear()
        try:
            yield
        finally:
            jsim._cached_run.cache_clear()
            psim.cache_clear()


@pytest.fixture
def salted_reference():
    with salted():
        yield


@pytest.fixture(scope="module")
def salted_module():
    """``salted`` for a whole module whose tests share one seeding, so the
    memoized runs of one test serve the next."""
    with salted():
        yield


def assert_same(a, b, path: str = "result") -> None:
    """``a`` (the reference's) equals ``b`` (the port's) exactly: integers
    and arrays by value and dtype, floats bit for bit, dataclasses field by
    field. A JAX array compares as its numpy value."""
    if hasattr(a, "__array__") and not isinstance(a, (np.ndarray, np.generic)):
        a = np.asarray(a)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b) if not isinstance(b, np.generic) else b
        assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} vs {b.dtype}"
        assert np.shape(a) == np.shape(b), f"{path}: shape"
        same = np.asarray(a).tobytes() == np.asarray(b).tobytes()
        if not same:
            diff = np.flatnonzero(np.asarray(a).ravel()
                                  != np.asarray(b).ravel())
            raise AssertionError(f"{path}: {diff.size} elements differ, "
                                 f"first at {diff[:5]}")
    elif isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} vs {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert type(b) is float, f"{path}: {type(b)}"
        assert np.float64(a).view(np.uint64) == np.float64(b).view(np.uint64), \
            f"{path}: {a!r} vs {b!r}"
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} vs {b!r}"


def f32_bits(x: float) -> int:
    """The float32 bit pattern of ``x`` (a float32 value held as a float)."""
    assert float(np.float32(x)) == x, x
    return int(np.float32(x).view(np.uint32))
