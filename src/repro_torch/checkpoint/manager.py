"""Checkpoints in the JAX package's on-disk format (counterpart of its
``checkpoint/manager.py``), so each package restores the other's.

Format: ``<dir>/step_XXXXXXXX/`` holds ``shard_{host}.npz`` (one array
``leaf_{i}`` per leaf, in the reference's ``tree_flatten`` order: dict
keys sorted, lists in order, ``None`` no leaf; bf16 stored as f32, which
is lossless) and, from host 0, ``manifest.json`` (``step``, ``n_hosts``,
``treedef``, ``shapes``, ``dtypes`` named as numpy names them). A
checkpoint is written into ``step_XXXXXXXX.tmp{host}`` and published by
``os.replace``; :func:`latest` finds the newest complete one, so a torn
write is skipped. The ``.npz`` is written one leaf at a time (the zip of
``.npy`` members that ``np.savez`` writes), so the host holds one leaf,
not the whole state. :func:`restore` with ``mesh``/``shardings`` is the
elastic path: every rank reads the stored global arrays and keeps its
block of each leaf, so a checkpoint saved by one rank restores onto any
mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.parallel import sharding
from repro_torch.runtime.graphs import leaves, unflatten

MANIFEST = "manifest.json"


def treedef_str(tree) -> str:
    """The tree's structure as ``str`` of the reference's ``PyTreeDef``
    renders it for dicts, lists and ``None`` (``*`` for a leaf)."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, dict):
        items = ", ".join(f"{key!r}: {treedef_str(tree[key])}"
                          for key in sorted(tree))
        return "{" + items + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(treedef_str(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if tree is None:
        return "None"
    raise TypeError(f"no checkpoint layout for {type(tree).__name__}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as the array the reference stores: bf16 as f32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _write_npz(path: str, tensors) -> tuple[list, list]:
    """``np.savez(path, leaf_0=..., ...)`` of the tensors ``tensors``
    yields, one in host memory at a time; every member is stamped
    1980-01-01, so the same state is written as the same bytes. Returns
    the shapes and dtype names written."""
    shapes, dtypes = [], []
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, t in enumerate(tensors):
            shapes.append(list(t.shape))
            dtypes.append(_dtype_name(t))
            info = zipfile.ZipInfo(f"leaf_{i}.npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(t),
                                          allow_pickle=False)
    return shapes, dtypes


def _gathered(tree, mesh, shardings):
    """Every leaf of a tree of rank blocks gathered to its global tensor,
    one leaf at a time (every rank takes part)."""
    from repro_torch.parallel import comm
    mc = comm.MeshComm(mesh)
    for t, spec in zip(leaves(tree), sharding.spec_leaves(shardings),
                       strict=True):
        yield mc.gather(t, spec, purpose="checkpoint")


def save(directory: str, step: int, tree, *, host_id: int = 0,
         n_hosts: int = 1, mesh=None, shardings=None) -> str | None:
    """Write checkpoint ``step`` of ``tree``; returns its path.

    From a mesh (``mesh`` and ``shardings``, ``tree`` holding this rank's
    blocks): every rank gathers the leaves one at a time, rank 0 writes
    them in the one-host format (the file the unmeshed save of the
    global tree writes, byte for byte) and the others write nothing and
    return None; all ranks leave after a barrier, once the checkpoint is
    published."""
    import torch.distributed as dist
    if (mesh is None) != (shardings is None):
        raise ValueError("save from a mesh needs both mesh= and "
                         "shardings=")
    tensors = leaves(tree)
    if mesh is not None:
        tensors = _gathered(tree, mesh, shardings)
        if dist.get_rank() != 0:
            for _ in tensors:
                pass
            dist.barrier()
            return None
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    shapes, dtypes = _write_npz(os.path.join(tmp, f"shard_{host_id}.npz"),
                                tensors)
    if host_id == 0:
        manifest = dict(
            step=step,
            n_hosts=n_hosts,
            treedef=f"PyTreeDef({treedef_str(tree)})",
            shapes=shapes,
            dtypes=dtypes,
        )
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
    # atomic publish
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    if mesh is not None:
        dist.barrier()
    return path


def is_complete(path: str) -> bool:
    if not os.path.exists(os.path.join(path, MANIFEST)):
        return False
    with open(os.path.join(path, MANIFEST)) as f:
        m = json.load(f)
    return all(
        os.path.exists(os.path.join(path, f"shard_{h}.npz"))
        for h in range(m["n_hosts"])
    )


def latest(directory: str) -> str | None:
    """Newest *complete* checkpoint (torn writes are skipped)."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        (d for d in os.listdir(directory) if d.startswith("step_")
         and not d.endswith(".tmp0")),
        reverse=True,
    )
    for d in steps:
        p = os.path.join(directory, d)
        if is_complete(p):
            return p
    return None


def restore(path: str, like_tree, device=None, *, mesh=None,
            shardings=None):
    """Load a checkpoint into the structure and dtypes of ``like_tree``
    on ``device`` (``None`` = the GPU), one leaf at a time. Returns
    ``(tree, step)``.

    With ``mesh`` (a DeviceMesh this rank belongs to) and ``shardings``
    (a spec tree shaped like ``like_tree``, e.g.
    ``parallel.sharding.param_shardings``) each rank keeps only its block
    of every stored global leaf, cut by that leaf's spec (an elastic
    re-shard: the checkpoint may come from any mesh). ``like_tree``
    gives the global structure and dtypes. Without them the load is the
    whole tree, as written.
    """
    if (mesh is None) != (shardings is None):
        raise ValueError("restore onto a mesh needs both mesh= and "
                         "shardings=")
    dev = resolve_device(device)
    specs = (list(sharding.spec_leaves(shardings)) if shardings is not None
             else None)
    coords = sharding.mesh_coords(mesh) if mesh is not None else None
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    loaded = []
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for i, like in enumerate(leaves(like_tree)):
            a = data[f"leaf_{i}"]
            if specs is not None and a.ndim:  # a scalar is replicated
                a = a[sharding.local_slice(specs[i], a.shape, mesh, coords)]
            loaded.append(torch.from_numpy(a).to(dev).to(like.dtype))
    return unflatten(like_tree, loaded), manifest["step"]
