"""MagellanMapper on PyTorch and CUDA: the port of ``magellanmapper_tpu``.

The JAX package beside this one is the reference; this package computes
the same results with PyTorch on an NVIDIA Hopper card (and on the CPU,
through each kernel's plain PyTorch version). Layout mirrors the
reference so each counterpart is easy to find:

- ``ops/``      device primitives: separable filters and the LoG pyramid,
                preprocessing, peak finding and blob pruning.
- ``kernels/``  hand-written CUDA kernels (sources in ``csrc/``), each with
                its plain PyTorch twin and a launch counter.
- ``cv/``       detection: single-block ``blob_log`` and whole-stack block
                detection.
- ``io/``       the ``--proc detect`` command-line entry.
- ``testing``   seeded planted-nuclei volumes and result checks.

Host-side modules of the reference that never import jax (settings,
``cv.blobs``, ``cv.chunking``, ``io.cli``'s argument parsing and image
loading, ``utils.libmag``) are imported from ``magellanmapper_tpu`` as
they are. This package never imports jax.
"""

from magellanmapper_torch import device  # noqa: F401  (fp32 precision pins)

__version__ = "0.1.0"
