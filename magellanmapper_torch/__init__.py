"""MagellanMapper on PyTorch and CUDA: the port of ``magellanmapper_tpu``.

The JAX package beside this one is the reference; this package computes
the same results with PyTorch on an NVIDIA Hopper card (and on the CPU,
through each kernel's plain PyTorch version). Layout mirrors the
reference so each counterpart is easy to find:

- ``ops/``      device primitives: separable filters and the LoG pyramid,
                preprocessing, resampling, peak finding and blob pruning.
- ``kernels/``  hand-written CUDA kernels (sources in ``csrc/``), each with
                its plain PyTorch twin and a launch counter.
- ``cv/``       detection: single-block ``blob_log``/``detect_blobs`` and
                whole-stack block detection; label curation, heat maps
                and perimeters (``cv_nd``).
- ``atlas/``    registration: transforms, metrics, the Adam engine, the
                ``--register single`` task and its gauntlet fixture; the
                whole-image transform (``transformer``) and the label
                ontology (``ontology``).
- ``io/``       the command-line entry (``--proc detect|transform|
                preprocess``, ``--grid_search``, ``--register``), image,
                medical-image, blob-archive and database I/O, region
                exports and density images (``export_regions``).
- ``settings/`` ROI, grid-search and atlas profiles.
- ``stats/``    the detection grid search, per-region metrics (``vols``)
                and cluster counts (``clustering``).
- ``utils/``    path helpers.
- ``testing``   seeded planted-nuclei volumes and specimens, result
                checks.

The package stands alone: it imports nothing of ``magellanmapper_tpu``
and never imports jax. The host-side code it shares with the reference
(profiles, ``cv.blobs``, ``cv.chunking``, ``cv.verifier``, ``io.np_io``,
``io.sitk_io``, ``io.sqlite``, ``atlas.ontology``, path helpers) is
copied here under the reference's module names, keeping its behaviour
and file formats. Every entry point that takes a ``device`` runs on the
card unless ``"cpu"`` is asked for, and raises without a card.
"""

from magellanmapper_torch import device  # noqa: F401  (fp32 precision pins)

__version__ = "0.1.0"
