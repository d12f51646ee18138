"""Mesh construction over ``torch.distributed`` (counterpart of the JAX
package's ``launch/mesh.py``).

Functions only, never module-level meshes: importing this module touches
no process group and no device.

The port runs one process per device (SPMD). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names over every rank of the default process group:

* the group is NCCL for the card and gloo for the CPU, never one in
  place of the other: an existing group of the other kind, or an NCCL
  group that fails to start, raises;
* ranks started by ``torchrun`` (``WORLD_SIZE`` in the environment)
  join the group it describes; a process started alone makes a one-rank
  group of its own, through a ``FileStore`` under the checkout's
  ``build/`` directory;
* a spec needing more ranks than the group has raises ``ValueError``
  naming the launcher; one needing fewer raises too, since every rank
  runs the session and a rank outside the mesh would have no slots.

:func:`make_dryrun_mesh` is the dry run's counterpart of the reference's
``--xla_force_host_platform_device_count=512``: the production mesh
(``16x16``, or ``2x16x16`` with ``pod``) over a *fake* process group
(PyTorch's ``FakeStore`` and ``"fake"`` backend: every collective
returns at once and moves nothing), seen from rank 0. Only
``launch.dryrun`` reaches it: it refuses to start where a process group
exists, the process that made it tears it down, and the meshes above
never fall back to it (a fake group is not the backend they need).
"""

from __future__ import annotations

import contextlib
import math
import os
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device

STORE_DIR = Path(__file__).resolve().parents[3] / "build" / "mesh"


def init_process_group(device=None) -> None:
    """Start (or check) the default process group for ``device`` (None:
    the GPU); see the module docstring."""
    device = resolve_device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(
                f"the process group is {have!r}, a {device.type} mesh "
                f"needs {want!r}")
        return
    kwargs = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(want, **kwargs)
        return
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    path = STORE_DIR / f"store-{os.getpid()}"
    path.unlink(missing_ok=True)
    dist.init_process_group(want, store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1, **kwargs)


def make_mesh(shape, axes, *, device=None):
    """A DeviceMesh of ``shape`` with axis names ``axes`` over every rank
    of the process group (started for ``device`` if need be)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    device = resolve_device(device)
    need = math.prod(shape)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ or need == 1:
        init_process_group(device)
        have = dist.get_world_size()
    else:
        have = 1  # a process started alone: refuse before starting a group
    spec = "x".join(map(str, shape))
    if need > have:
        raise ValueError(
            f"mesh {spec!r} needs {need} devices, host has {have} "
            f"(torchrun --nproc-per-node {need} starts {need} ranks)")
    if need < have:
        raise ValueError(
            f"mesh {spec!r} covers {need} of the {have} ranks: every rank "
            f"of the process group must be in the mesh")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def parse_mesh_shape(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``'4x2'`` -> ``((4, 2), ('data', 'model'))``; ``'2'`` -> ``((2,),
    ('data',))``. The serving ``--mesh dxm`` flag and the cross-mesh test
    harness share this one parser so their shapes cannot drift.
    """
    try:
        shape = tuple(int(part) for part in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: want 'd' or 'dxm'") from None
    if not shape or len(shape) > 2 or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh spec {spec!r}: want 'd' or 'dxm' with "
                         f"positive sizes")
    return shape, ("data", "model")[: len(shape)]


def make_serving_mesh(spec: str, *, device=None):
    """Mesh for ``ServeSession`` waves from a ``'d'``/``'dxm'`` spec
    string; raises with the rank count when the process group cannot
    satisfy the shape (start N ranks with ``torchrun --nproc-per-node
    N``)."""
    shape, axes = parse_mesh_shape(spec)
    return make_mesh(shape, axes, device=device)


@contextlib.contextmanager
def make_dryrun_mesh(multi_pod: bool = False, *, spec: str | None = None):
    """The production mesh over a fake process group, as rank 0 (or the
    mesh of ``spec``, ``'d'``/``'dxm'``), for the block; the group is
    destroyed after it. Raises ``RuntimeError`` where a process group
    already exists."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a dry-run mesh needs a process without a process group; this "
            f"one holds a {dist.get_backend()!r} group")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if spec is not None:
        shape, axes = parse_mesh_shape(spec)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()
