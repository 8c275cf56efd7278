"""Background workers for the GUI's long tasks.

Copy of ``magellanmapper_tpu/gui/threads.py`` (the reference's
``SetupImportThread``, ``ImportThread``, ``RemapLevelThread``,
``AnnotateLabels`` and ``FileOpenHandler``): ``start()`` runs the task on
a daemon ``threading.Thread`` and returns at once, ``fn_progress`` and
``fn_success`` fire from the worker, and ``result()`` joins and returns
the output, raising the worker's exception in the caller. The workers'
tasks (import, ontology remapping) run on the host; a task that used a
card would take its device from the caller, as an argument, never from
the thread's CUDA state.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np


class _WorkerTask:
    """Base: run :meth:`run` on a daemon thread, reporting via callbacks."""

    def __init__(self, fn_success: Optional[Callable] = None,
                 fn_progress: Optional[Callable] = None):
        self.fn_success = fn_success
        self.fn_progress = fn_progress
        self._thread: Optional[threading.Thread] = None
        self._result = None
        self._exc: Optional[BaseException] = None

    def _progress(self, *args) -> None:
        if self.fn_progress is not None:
            self.fn_progress(*args)

    def _target(self):
        try:
            self._result = self.run()
        except BaseException as exc:  # surfaced by result()
            self._exc = exc
            return
        if self.fn_success is not None:
            self.fn_success(self._result)

    def start(self) -> "_WorkerTask":
        """Launch the task on a background thread; returns ``self``."""
        self._thread = threading.Thread(target=self._target, daemon=True)
        self._thread.start()
        return self

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the worker; True when it finished."""
        if self._thread is None:
            return False
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None):
        """Join and return the task output (runs inline if never
        started), re-raising any worker exception."""
        if self._thread is None:
            self.start()
        self.wait(timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def run(self):  # pragma: no cover - overridden
        raise NotImplementedError


#: the reference's other name for the base class
_InlineTask = _WorkerTask


class SetupImportThread(_WorkerTask):
    """Scan files and build import metadata
    (reference ``import_threads.SetupImportThread :13``)."""

    def __init__(self, chl_paths, fn_success=None):
        super().__init__(fn_success)
        self.chl_paths = chl_paths

    def run(self):
        from magellanmapper_torch.io import importer
        import_md = {}
        for chl, paths in (self.chl_paths or {}).items():
            for path in np.atleast_1d(paths):
                base, offset, size = importer.deconstruct_img_name(
                    str(path))
                import_md[chl] = {
                    "path": str(path), "base": base,
                    "offset": offset, "size": size}
        return import_md


class ImportThread(_WorkerTask):
    """Run an image import (reference ``import_threads.ImportThread
    :42``)."""

    def __init__(self, mode, prefix, chl_paths=None, import_md=None,
                 fn_success=None, fn_progress=None):
        super().__init__(fn_success, fn_progress)
        self.mode = mode
        self.prefix = prefix
        self.chl_paths = chl_paths
        self.import_md = import_md

    def run(self):
        from magellanmapper_torch.io import importer
        paths = []
        for chl, p in (self.chl_paths or {}).items():
            paths.extend(np.atleast_1d(p).tolist())
        self._progress(0, "importing")
        if len(paths) == 1:
            out = importer.import_tiff(paths[0], self.prefix)
        else:
            out = importer.import_planes_to_stack(paths, self.prefix)
        self._progress(100, "done")
        return out


class RemapLevelThread(_WorkerTask):
    """Remap a labels image to an ontology level
    (reference ``atlas_threads.RemapLevelThread :15``)."""

    def __init__(self, labels_img, labels_ref, level,
                 fn_success=None, fn_progress=None):
        super().__init__(fn_success, fn_progress)
        self.labels_img = labels_img
        self.labels_ref = labels_ref
        self.level = level

    def run(self):
        from magellanmapper_torch.atlas import ontology
        self._progress(0, f"remapping to level {self.level}")
        out = ontology.make_labels_level(
            self.labels_img, self.labels_ref.ref_lookup, self.level)
        self._progress(100, "done")
        return out


class AnnotateLabels(_WorkerTask):
    """Gather label names under the cursor/region
    (reference ``atlas_threads.AnnotateLabels :50``)."""

    def __init__(self, labels_img, labels_ref, label_ids,
                 fn_success=None):
        super().__init__(fn_success)
        self.labels_img = labels_img
        self.labels_ref = labels_ref
        self.label_ids = label_ids

    def run(self):
        from magellanmapper_torch.atlas import ontology
        out = {}
        for lid in np.atleast_1d(self.label_ids):
            entry = self.labels_ref.ref_lookup.get(int(lid))
            out[int(lid)] = ontology.get_label_name(entry, side=True)
        return out


class FileOpenHandler:
    """Open-with-file event handler (reference
    ``event_handlers.FileOpenHandler :11``): queues paths delivered by
    the OS and feeds them to the visualization's loader."""

    def __init__(self, vis):
        self.vis = vis
        self.pending = []

    def handle(self, path: str) -> bool:
        self.pending.append(path)
        if hasattr(self.vis, "load_image"):
            self.vis.load_image(path)
            return True
        return False
