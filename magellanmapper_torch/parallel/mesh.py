"""Rank mesh construction for spatial-parallel volume processing.

Port of ``magellanmapper_tpu/parallel/mesh.py``. The axes keep their
meaning:

 - ``dp``: data parallel over independent blocks/volumes,
 - ``sp``: spatial parallel over z within one volume (halo exchange
   between neighbouring ranks),
 - ``spy``: spatial parallel over y (always present; size 1 unless
   requested).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks of an
initialised process group. A world of one initialises itself (NCCL for
the card, gloo for the CPU); a larger one is started by ``torchrun`` or
:func:`magellanmapper_torch.parallel.launch.spawn`.
"""

from __future__ import annotations

import os
import tempfile
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from magellanmapper_torch import device as device_mod

#: mesh axis names, outermost first
AXES = ("dp", "sp", "spy")

#: seconds a collective may wait before the process group raises
TIMEOUT_S = 600.0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(backend: Optional[str] = None, device="cuda",
               timeout_s: float = TIMEOUT_S) -> None:
    """Initialise the default process group when it is not yet: from
    ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``) when set, else a world of one over a file store.
    ``backend`` defaults to :func:`default_backend`; a CUDA ``device``
    without a card raises. On NCCL each rank takes the card of its
    ``LOCAL_RANK``."""
    if dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        device_mod.require_cuda()
    backend = backend or default_backend(device)
    timeout = timedelta(seconds=timeout_s)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, timeout=timeout)
        return
    store = os.path.join(tempfile.mkdtemp(prefix="mmtorch_world1_"),
                         "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1, timeout=timeout)


def make_mesh(
        n_devices: Optional[int] = None,
        dp: Optional[int] = None,
        sp: Optional[int] = None,
        devices: Optional[Sequence[int]] = None,
        spy: int = 1, device="cuda") -> DeviceMesh:
    """Build a ``(dp, sp, spy)`` mesh over the ranks of the process group.

    Defaults put every rank on the z spatial axis; pass ``dp`` to trade
    ranks into block parallelism and ``spy`` to split planes over y as
    well. ``devices`` are global ranks (default: all of them, in order)
    and ``n_devices`` takes the first of them; every rank of the world
    calls this alike, and a rank outside the mesh gets a mesh whose
    ``get_coordinate()`` is None. Without a process group a world of one
    initialises itself (:func:`init_world` on ``device``); a larger mesh
    raises, naming the launchers.
    """
    if devices is not None and n_devices is None:
        n_devices = len(devices)
    if n_devices is not None:
        dp, sp = _factor(n_devices, dp, sp, spy)
    if not dist.is_initialized():
        if (n_devices or 1) > 1:
            raise RuntimeError(
                f"a mesh of {n_devices} ranks needs an initialised process "
                "group: start the ranks with torchrun (torchrun "
                "--standalone --nproc-per-node N ...) or "
                "magellanmapper_torch.parallel.launch.spawn")
        init_world(device=device)
    if devices is None:
        devices = list(range(dist.get_world_size()))
    if n_devices is None:
        n_devices = len(devices)
        dp, sp = _factor(n_devices, dp, sp, spy)
    if len(devices) < n_devices:
        raise ValueError(
            f"a mesh of {n_devices} ranks in a world of {len(devices)}")
    devices = list(devices)[:n_devices]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.as_tensor(np.asarray(devices).reshape(dp, sp, spy))
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def _factor(n_devices: int, dp: Optional[int], sp: Optional[int],
            spy: int) -> Tuple[int, int]:
    """``(dp, sp)`` of ``n_devices`` ranks with ``spy`` (the reference's
    rules: all on ``sp`` by default, the other from the one given); a
    product other than ``n_devices`` raises ``ValueError``."""
    spatial = n_devices // max(1, spy)
    if dp is None and sp is None:
        dp, sp = 1, spatial
    elif dp is None:
        dp = spatial // sp
    elif sp is None:
        sp = spatial // dp
    if dp * sp * spy != n_devices:
        raise ValueError(
            f"dp ({dp}) x sp ({sp}) x spy ({spy}) must equal device "
            f"count {n_devices}")
    return dp, sp


def shape(mesh: DeviceMesh) -> dict:
    """``{"dp": n, "sp": n, "spy": n}``, as the reference's
    ``Mesh.shape``."""
    return dict(zip(AXES, (int(s) for s in mesh.mesh.shape)))


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = shape(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's position along ``axes``, row-major over them (the
    order the reference's multi-axis ``all_gather`` tiles in)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    coord = dict(zip(AXES, mesh.get_coordinate()))
    sizes = shape(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank belongs to ``mesh``."""
    return mesh.get_coordinate() is not None


def shard_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[start, stop)`` of part ``index`` of ``n`` items cut into
    ``parts`` contiguous parts, the first ``n % parts`` one longer
    (``torch.tensor_split``'s cut)."""
    base, extra = divmod(int(n), int(parts))
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)
