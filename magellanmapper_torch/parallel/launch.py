"""Start a world of ranks on one host.

:func:`spawn` runs ``fn`` in ``world_size`` processes started with
``torch.multiprocessing`` (the spawn method: each rank imports the port
afresh and nothing of its caller's module), each in a process group that
meets at a file store in a temporary directory, so no TCP port can
collide between concurrent worlds. Every rank's return value comes back
to the caller, in rank order. A rank that raises fails the caller with
its traceback; a world that has not finished within ``timeout_s`` is
killed and raises ``TimeoutError``, so a hung collective fails its caller
instead of hanging it.

``torchrun`` starts the same ranks across GPUs:
``torchrun --standalone --nproc-per-node N -m magellanmapper_torch.io.cli
... --mesh 1,N``.
"""

from __future__ import annotations

import importlib
import os
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.parallel import mesh as mesh_mod


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int,
               backend: str, device: str, work_dir: str,
               timeout_s: float) -> None:
    """One rank: join the group, run ``fn(*args)``, save its result."""
    if torch.device(device).type == "cpu":
        # ranks share the host's cores (the test workers too)
        torch.set_num_threads(1)
    elif backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(work_dir, 'store')}",
        rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        torch.save(out, os.path.join(work_dir, f"result_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: Optional[str] = None,
          device="cuda", timeout_s: float = 600.0,
          args: Sequence = ()) -> List:
    """Run ``fn(*args)`` on ``world_size`` ranks; returns each rank's
    result (saved with ``torch.save``), rank 0 first.

    ``fn`` must be a module-level function of the port or of the running
    script, since each rank imports it afresh (the ranks' results are
    unpickled here, from this call's own directory). ``backend`` defaults to
    NCCL for ``device="cuda"`` and gloo for the CPU; it is never changed
    silently: ask for ``"gloo"`` to run several ranks on one card, which
    then compute on the card and stage their collectives through host
    memory. CPU ranks run one thread each."""
    if torch.device(device).type == "cuda":
        device_mod.require_cuda()
    backend = backend or mesh_mod.default_backend(device)
    work_dir = tempfile.mkdtemp(prefix="mmtorch_world_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, tuple(args), world_size, backend, str(device),
                          work_dir, timeout_s),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"a world of {world_size} ranks ({backend}) did not "
                    f"finish {getattr(fn, '__name__', fn)} within "
                    f"{timeout_s} s")
        return [torch.load(os.path.join(work_dir, f"result_{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        shutil.rmtree(work_dir, ignore_errors=True)


def _resolve(path: str) -> Callable:
    """``"package.module:attr.attr"`` to the object it names (port
    modules only)."""
    module, _, attr = path.partition(":")
    if not module.startswith("magellanmapper_torch."):
        raise ValueError(f"{path} is not a function of the port")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def run_cases(cases: Sequence[dict]) -> dict:
    """A rank target that runs several sharded calls in one world.

    Each case is a dict: ``key``, ``fn`` (``"module:function"`` of the
    port), ``args``, ``kwargs`` and ``mesh`` (``make_mesh`` keywords, or
    None for a call without one). Every rank builds each case's mesh;
    the ranks in it call ``fn(*args, mesh=mesh, **kwargs)``. Returns
    ``{key: result}`` of the ranks that ran each case."""
    out = {}
    for case in cases:
        kwargs = dict(case.get("kwargs") or {})
        mesh_kw = case.get("mesh")
        if mesh_kw is not None:
            mesh = mesh_mod.make_mesh(**mesh_kw)
            if not mesh_mod.in_mesh(mesh):
                continue
            kwargs["mesh"] = mesh
        out[case["key"]] = _resolve(case["fn"])(
            *case.get("args", ()), **kwargs)
    return out
