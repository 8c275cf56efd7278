"""BrainGlobe atlases from their local cache.

Copy of ``magellanmapper_tpu/brain_globe.py``: ``BrainGlobeMM`` opens a
cached atlas (the standard ``~/.brainglobe`` layout:
``reference.tiff``/``annotation.tiff`` and ``metadata.json``) as an
``Image5d`` without the ``brainglobe-atlasapi`` package; downloading an
atlas that is not cached needs that package and raises without it, as
in the reference. ``BrainGlobeCtrl`` and the task classes run the same
calls inline.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional


_logger = logging.getLogger(__name__)

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".brainglobe")


class BrainGlobeMM:
    """BrainGlobe atlas manager (reference ``bg_model.BrainGlobeMM``)."""

    def __init__(self, cache_dir: str = DEFAULT_CACHE):
        self.cache_dir = cache_dir

    def get_avail_atlases(self) -> List[str]:
        """Locally cached atlas names (remote listing needs egress)."""
        if not os.path.isdir(self.cache_dir):
            return []
        return sorted(
            d for d in os.listdir(self.cache_dir)
            if os.path.isdir(os.path.join(self.cache_dir, d)))

    def get_atlas(self, name: str, download: bool = False):
        """Load a cached atlas as ``(Image5d, labels_img, meta)``."""
        atlas_dir = self._find_dir(name)
        if atlas_dir is None:
            if not download:
                raise FileNotFoundError(
                    f"atlas {name} not cached under {self.cache_dir}")
            try:
                from brainglobe_atlasapi import BrainGlobeAtlas
            except ImportError as exc:
                raise ImportError(
                    "brainglobe-atlasapi not installed and atlas not "
                    "cached; download is unavailable") from exc
            BrainGlobeAtlas(name)  # triggers download into the cache
            atlas_dir = self._find_dir(name)

        from magellanmapper_torch.io import np_io, tiff
        meta = {}
        meta_path = os.path.join(atlas_dir, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        ref = tiff.read_tiff(os.path.join(atlas_dir, "reference.tiff"))
        ann = tiff.read_tiff(os.path.join(atlas_dir, "annotation.tiff"))
        res = meta.get("resolution", [1.0, 1.0, 1.0])
        img5d = np_io.Image5d(
            img=ref[None], img_io="brain_globe",
            meta={"resolutions": [list(res)], "bg_meta": meta})
        return img5d, ann, meta

    def _find_dir(self, name: str) -> Optional[str]:
        if not os.path.isdir(self.cache_dir):
            return None
        for d in os.listdir(self.cache_dir):
            if d.startswith(name):
                cand = os.path.join(self.cache_dir, d)
                if os.path.exists(os.path.join(cand, "reference.tiff")):
                    return cand
        return None

    def remove_atlas(self, name: str) -> bool:
        """Delete a cached atlas."""
        import shutil
        atlas_dir = self._find_dir(name)
        if atlas_dir:
            shutil.rmtree(atlas_dir)
            return True
        return False


class BrainGlobeCtrl:
    """Synchronous BrainGlobe controller (reference
    ``brain_globe/bg_controller.BrainGlobeCtrl :121``). The reference
    fetches listings/downloads on Qt threads; here the calls run inline
    and report through the same callback surface."""

    def __init__(self, fn_set_atlases_table=None, fn_feedback=None,
                 fn_progress=None, fn_opened_atlas=None):
        self.fn_set_atlases_table = fn_set_atlases_table
        self.fn_feedback = fn_feedback or (lambda msg: None)
        self.fn_progress = fn_progress
        self.fn_opened_atlas = fn_opened_atlas
        self.bg_mm = BrainGlobeMM()

    def update_atlas_table(self) -> List[str]:
        """Fetch the available-atlas listing and push it to the table
        callback."""
        atlases = self.bg_mm.get_avail_atlases()
        if self.fn_set_atlases_table is not None:
            self.fn_set_atlases_table(atlases)
        return atlases

    def open_atlas(self, name: str, download: bool = False):
        """Open (optionally downloading) an atlas and notify."""
        self.fn_feedback(f"opening atlas {name}")
        atlas = self.bg_mm.get_atlas(name, download)
        if atlas is not None and self.fn_opened_atlas is not None:
            self.fn_opened_atlas(atlas)
        return atlas

    def remove_atlas(self, name: str) -> bool:
        ok = self.bg_mm.remove_atlas(name)
        self.fn_feedback(
            f"removed atlas {name}" if ok else f"could not remove {name}")
        return ok


class _InlineBGTask:
    """Inline stand-in for the reference's Qt threads."""

    def __init__(self, fn_success=None, fn_feedback=None):
        self.fn_success = fn_success
        self.fn_feedback = fn_feedback

    def _feedback(self, msg):
        if self.fn_feedback is not None:
            self.fn_feedback(msg)

    def start(self):
        out = self.run()
        if self.fn_success is not None:
            self.fn_success(out)
        return out


class SetupAtlasesThread(_InlineBGTask):
    """Fetch the atlas listing (reference
    ``bg_controller.SetupAtlasesThread :~30``; Qt thread in the
    reference, inline here)."""

    def __init__(self, bg_mm: "BrainGlobeMM", fn_success=None,
                 fn_feedback=None):
        super().__init__(fn_success, fn_feedback)
        self.bg_mm = bg_mm

    def run(self):
        self._feedback("fetching atlas listing")
        return self.bg_mm.get_avail_atlases()


class AccessAtlasThread(_InlineBGTask):
    """Open/download one atlas (reference
    ``bg_controller.AccessAtlasThread``)."""

    def __init__(self, bg_mm: "BrainGlobeMM", name: str,
                 download: bool = False, fn_success=None,
                 fn_feedback=None):
        super().__init__(fn_success, fn_feedback)
        self.bg_mm = bg_mm
        self.name = name
        self.download = download

    def run(self):
        self._feedback(f"accessing atlas {self.name}")
        return self.bg_mm.get_atlas(self.name, self.download)
