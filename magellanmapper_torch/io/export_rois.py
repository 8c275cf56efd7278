"""Blob exports: the blob archive as CSV.

Copy of ``blobs_to_csv`` of ``magellanmapper_tpu/io/export_rois.py``,
which ``--proc export_blobs`` runs. The ROI exports of that module
(``export_rois``, ``--proc export_rois``) are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import pandas as pd

from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.utils import libmag

_logger = logging.getLogger(__name__)


def blobs_to_csv(rc_or_blobs, out_path: Optional[str] = None
                 ) -> pd.DataFrame:
    """Export blobs to CSV: from a parsed command line (its ``prefix``,
    else its first image, names the archive ``<base>_blobs.npz`` and the
    default output ``<base>_blobs.csv``) or from a blob array (columns
    named by :class:`~magellanmapper_torch.cv.blobs.BlobCols`, written
    only when ``out_path`` is given)."""
    if hasattr(rc_or_blobs, "filenames"):
        base = rc_or_blobs.prefix or rc_or_blobs.filenames[0]
        blobs = blobs_mod.Blobs().load_blobs(
            libmag.combine_paths(base, "blobs.npz"))
        arr = blobs.blobs
        out_path = out_path or libmag.combine_paths(base, "blobs.csv")
        cols = blobs.cols
    else:
        arr = np.asarray(rc_or_blobs)
        cols = [c.value for c in blobs_mod.BlobCols][:arr.shape[1]]
    df = pd.DataFrame(arr, columns=cols)
    if out_path:
        df.to_csv(out_path, index=False)
        _logger.info("exported %d blobs to %s", len(df), out_path)
    return df
