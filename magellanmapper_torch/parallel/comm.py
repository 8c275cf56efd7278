"""Collectives over the axes of a rank mesh.

The reference's ``psum``/``all_gather``/``ppermute`` inside ``shard_map``
become ``torch.distributed`` calls on the mesh's per-axis groups; a
collective over several axes runs one axis after the other (innermost
first for a gather, so the result tiles row-major over the axes, as the
reference's does). Axes of size 1 cost nothing.

Gloo's calls take CPU tensors only. Where a group's backend is gloo and a
tensor lies on a card (several ranks sharing one card), it is staged
through pinned host memory here, and nowhere else: :func:`_on_backend`
and :func:`_empty_on_backend` make every buffer that a call hands to the
backend.

:func:`all_reduce_grad` and :func:`all_gather_grad` carry autograd: the
backward of a sum over ranks is a sum of the upstream gradients over the
ranks, and that of a gather is the sum over ranks of each rank's slice.
A loss computed alike on every rank from their results thus
differentiates ``world`` times the loss; callers divide (see
``atlas.reg_engine``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

from magellanmapper_torch.parallel import mesh as mesh_mod


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _on_backend(t: torch.Tensor, group, copy: bool = False
                ) -> torch.Tensor:
    """``t`` as ``group``'s backend takes it: a pinned host copy of a CUDA
    tensor on gloo, else ``t`` contiguous (a copy of it with ``copy``, for
    a call that writes in place)."""
    if _host_staged(t, group):
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return t.clone(memory_format=torch.contiguous_format) if copy \
        else t.contiguous()


def _empty_on_backend(like: torch.Tensor, group) -> torch.Tensor:
    """An empty buffer of ``like``'s shape and type that ``group``'s
    backend fills: pinned host memory for a CUDA tensor on gloo."""
    if _host_staged(like, group):
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def _groups(mesh, axes) -> List:
    """The process groups of ``axes`` whose size exceeds 1."""
    sizes = mesh_mod.shape(mesh)
    return [mesh.get_group(a) for a in _axes(axes) if sizes[a] > 1]


def all_reduce(t: torch.Tensor, mesh, axes=mesh_mod.AXES,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` over ``axes`` (a new tensor)."""
    for group in _groups(mesh, axes):
        buf = _on_backend(t, group, copy=True)
        dist.all_reduce(buf, op=op, group=group)
        t = buf.to(t.device)
    return t


def _gather_one(t: torch.Tensor, group) -> torch.Tensor:
    src = _on_backend(t, group)
    parts = [_empty_on_backend(src, group)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(t.device)


def all_gather(t: torch.Tensor, mesh, axes=mesh_mod.AXES) -> torch.Tensor:
    """Every rank's ``t`` along ``axes``, concatenated on dim 0 in
    row-major rank order (the reference's ``all_gather(tiled=True)``).
    Shapes must agree across ranks."""
    for group in reversed(_groups(mesh, axes)):
        t = _gather_one(t, group)
    return t


def all_gather_object(obj, mesh, axes=mesh_mod.AXES) -> list:
    """Every rank's picklable ``obj`` along ``axes``, in row-major rank
    order."""
    out = [obj]
    for group in reversed(_groups(mesh, axes)):
        parts: list = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, out, group=group)
        out = [o for part in parts for o in part]
    return out


def on_writer(mesh, fn: Callable[[], object]):
    """Run ``fn`` (which writes files) on the mesh's first rank only
    (rank 0 of a mesh over the whole world), and return its result on
    every rank of the mesh once it is done; without a mesh, ``fn()``."""
    if mesh is None or not dist.is_initialized():
        return fn()
    first = int(mesh.mesh.reshape(-1)[0])
    out = fn() if dist.get_rank() == first else None
    return all_gather_object(out, mesh)[0]


def exchange(sends: Sequence, recvs: Sequence, group) -> None:
    """Point-to-point exchange on ``group``: each ``(tensor, peer)`` of
    ``sends`` goes to group rank ``peer``, and each ``(tensor, peer)`` of
    ``recvs`` is filled from it, in one batch."""
    if not sends and not recvs:
        return
    send_bufs = [(_on_backend(t, group), p) for t, p in sends]
    recv_bufs = [(_empty_on_backend(t, group), p) for t, p in recvs]
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, p),
                      group) for t, p in send_bufs]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, p),
                       group) for t, p in recv_bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for (dst, _), (buf, _) in zip(recvs, recv_bufs):
        dst.copy_(buf)


def all_to_all(chunks: Sequence[torch.Tensor], mesh, axis: str
               ) -> List[torch.Tensor]:
    """Send ``chunks[j]`` to rank ``j`` of ``axis`` and return the chunk
    each rank of the axis sent here, in rank order. Chunks may differ in
    shape; every rank learns the shapes it receives first."""
    n = mesh_mod.axis_size(mesh, axis)
    me = mesh_mod.axis_index(mesh, axis)
    if n == 1:
        return [chunks[0]]
    shapes = all_gather_object([tuple(c.shape) for c in chunks], mesh,
                               axis)
    group = mesh.get_group(axis)
    out = [torch.empty(shapes[src][me], dtype=chunks[0].dtype,
                       device=chunks[0].device) for src in range(n)]
    out[me] = chunks[me]
    others = [j for j in range(n) if j != me]
    exchange([(chunks[j], j) for j in others],
             [(out[j], j) for j in others], group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.n = t.shape[0]
        ctx.index = mesh_mod.axis_index(mesh, axes)
        return all_gather(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce(grad, ctx.mesh, ctx.axes)
        lo = ctx.index * ctx.n
        return total[lo:lo + ctx.n], None, None


def all_reduce_grad(t: torch.Tensor, mesh, axes=mesh_mod.AXES
                    ) -> torch.Tensor:
    """:func:`all_reduce` (sum) that carries autograd."""
    return _AllReduceSum.apply(t, mesh, _axes(axes))


def all_gather_grad(t: torch.Tensor, mesh, axes=mesh_mod.AXES
                    ) -> torch.Tensor:
    """:func:`all_gather` that carries autograd."""
    return _AllGather.apply(t, mesh, _axes(axes))
