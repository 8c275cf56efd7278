"""Multi-rank volume processing over ``torch.distributed``.

Port of ``magellanmapper_tpu/parallel/``. The reference runs one process
over a ``jax.sharding.Mesh`` of devices; here every rank is a process of
its own (one per GPU, started by ``torchrun`` or :func:`launch.spawn`),
and a ``DeviceMesh`` named ``("dp", "sp", "spy")`` over the ranks of the
process group carries the same axes (:mod:`.mesh`). Every rank calls a
sharded function with the same arguments and gets the same result back;
only the mesh's first rank (rank 0) writes files. Collectives go through
:mod:`.comm`, which stages CUDA tensors through pinned host memory where
the group's backend is gloo (several ranks sharing one card). :mod:`.halo` detects blobs in a
z (and y) sharded volume with halo exchange, :mod:`.distributed` deals
detection blocks over the ranks, :mod:`.dryrun` runs every sharded path
once on tiny shapes.
"""
