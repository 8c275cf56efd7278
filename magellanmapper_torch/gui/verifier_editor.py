"""Blob verification editor: a paged grid of blob patches.

Copy of ``magellanmapper_tpu/gui/verifier_editor.py`` (the reference's
``VerifierEditor``): ``nrows x ncols`` blobs a page, a click cycles a
blob's confirmed flag, and edits flow back through ``fn_update_blob``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from magellanmapper_torch.gui.widgets import BLOB_COLORS


class VerifierEditor:
    """Paged blob verification state (reference ``VerifierEditor``)."""

    @dataclass
    class BlobView:
        """One displayed blob: its patch and the blob row."""
        patch: np.ndarray
        blob: np.ndarray
        index: int

    def __init__(self, img5d, blobs, title: Optional[str] = None,
                 fn_update_blob: Optional[Callable] = None,
                 nrows: int = 3, ncols: int = 3, patch_size: int = 24):
        self.img5d = img5d
        self.blobs = blobs
        self.title = title
        self.fn_update_blob = fn_update_blob
        self._nrows = nrows
        self._ncols = ncols
        self._patch_size = patch_size
        self.page = 0

    @property
    def _blob_arr(self) -> np.ndarray:
        return self.blobs.blobs if hasattr(self.blobs, "blobs") \
            else self.blobs

    @property
    def per_page(self) -> int:
        return self._nrows * self._ncols

    @property
    def n_pages(self) -> int:
        n = len(self._blob_arr)
        return max(1, -(-n // self.per_page))

    def build_page(self, page: Optional[int] = None) -> List["BlobView"]:
        """Blob views for one page: 2D patch around each blob center."""
        if page is not None:
            self.page = int(np.clip(page, 0, self.n_pages - 1))
        arr = self._blob_arr
        vol = self.img5d[0] if np.ndim(self.img5d) >= 4 else self.img5d
        half = self._patch_size // 2
        views = []
        start = self.page * self.per_page
        for i in range(start, min(start + self.per_page, len(arr))):
            b = arr[i]
            z = int(np.clip(round(b[0]), 0, vol.shape[0] - 1))
            y = int(round(b[1]))
            x = int(round(b[2]))
            plane = np.asarray(vol[z])
            pad = np.pad(plane, ((half, half), (half, half)), mode="edge")
            patch = pad[y:y + 2 * half, x:x + 2 * half]
            views.append(self.BlobView(patch, np.array(b), i))
        return views

    def next_page(self) -> int:
        self.page = min(self.page + 1, self.n_pages - 1)
        return self.page

    def prev_page(self) -> int:
        self.page = max(self.page - 1, 0)
        return self.page

    def flag_blob(self, index: int, flag: Optional[int] = None) -> int:
        """Set (or cycle) the confirmed flag of a blob by global index."""
        arr = self._blob_arr
        old = arr[index].copy()
        if flag is None:
            cycle = (-1, 0, 1)
            cur = int(arr[index][4])
            flag = cycle[(cycle.index(cur) + 1) % 3] if cur in cycle \
                else -1
        arr[index][4] = flag
        if self.fn_update_blob is not None:
            self.fn_update_blob(arr[index], old)
        return int(flag)

    def blob_color(self, index: int) -> str:
        return BLOB_COLORS.get(int(self._blob_arr[index][4]), "none")
