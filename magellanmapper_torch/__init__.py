"""MagellanMapper on PyTorch and CUDA: the port of ``magellanmapper_tpu``.

The JAX package beside this one is the reference; this package computes
the same results with PyTorch on an NVIDIA Hopper card (and on the CPU,
through each kernel's plain PyTorch version). Layout mirrors the
reference so each counterpart is easy to find:

- ``ops/``      device primitives: separable filters and the LoG pyramid,
                preprocessing, resampling, peak finding and blob pruning,
                3D rendering (``render3d``: ray casting and shear-warp).
- ``kernels/``  hand-written CUDA kernels (sources in ``csrc/``), each with
                its plain PyTorch twin and a launch counter; host C++
                TIFF and JPEG decoders and the threaded block extractor
                in ``csrc/host/`` (built with g++).
- ``cv/``       detection: single-block ``blob_log``/``detect_blobs`` and
                whole-stack block detection; label curation, heat maps
                and perimeters (``cv_nd``).
- ``atlas/``    registration: transforms, metrics, the Adam engine, the
                ``--register single`` task and its gauntlet fixture; the
                whole-image transform (``transformer``), the label
                ontology (``ontology``) and labels-difference images
                painted on the device (``reg_tasks``).
- ``io/``       the command-line entry (``--proc detect|transform|
                preprocess|import_only|load|export_*|extract|animated``,
                ``--plot_2d``, ``--df``, ``--grid_search``,
                ``--register``), TIFF, image, medical-image, blob-archive,
                table (``df_io``) and database I/O, block extraction
                (``_blockio``), import (``importer``), the pipeline
                runner from raw tiles to blobs (``pipelines``), region
                exports and density images (``export_regions``), ROI
                exports (``export_rois``), plane files and animations
                (``export_stack``).
- ``stitch/``   tile stitching: phase correlation and fusion on the device
                (``stitcher``), tile grids and mesoSPIM conversion
                (``acquisition``).
- ``plot/``     colormaps, figure support, 2D plots (``plot_2d``, which
                imports matplotlib; the others import it only where a
                figure is made), ROI preprocessing and deconvolution
                (``plot_3d``).
- ``settings/`` ROI, grid-search, atlas and preference profiles, the task
                and metric vocabularies (``config``), logging (``logs``).
- ``stats/``    the detection grid search, per-region metrics (``vols``)
                and cluster counts (``clustering``), the regions' tables
                of a study (``atlas_stats``) and its group statistics
                (``clrstats``).
- ``utils/``    path, number and enum helpers (``libmag``), timers,
                checkpoints and the profiler.
- ``native/``   the reference's ``native`` names (block extraction, the
                TIFF and JPEG codecs) over the host libraries of ``io/``.
- ``testing``   seeded planted-nuclei volumes, specimens and tile sets,
                result checks.

``python -m magellanmapper_torch <CLI arguments>`` starts the command
line (``__main__.py``, the reference's ``run.py``).

The package stands alone: it imports nothing of ``magellanmapper_tpu``
and never imports jax. The host-side code it shares with the reference
(profiles, ``cv.blobs``, ``cv.chunking``, ``cv.verifier``, ``io.np_io``,
``io.sitk_io``, ``io.sqlite``, ``io.tiff``, ``io.importer``, ``io.df_io``,
``io.load_env``, ``stitch.acquisition``, ``atlas.ontology``,
``brain_globe``, the stats tables, ``libmag``) is
copied here under the reference's module names, keeping its behaviour
and file formats. Every entry point that takes a ``device`` runs on the
card unless ``"cpu"`` is asked for, and raises without a card.
"""

from magellanmapper_torch import device  # noqa: F401  (fp32 precision pins)

__version__ = "0.1.0"
