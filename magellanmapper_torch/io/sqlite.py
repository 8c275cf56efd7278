"""Blob/ROI/truth database (sqlite3) in the reference's schema.

Copy of what the port uses from ``magellanmapper_tpu/io/sqlite.py``: the
same tables (``about``/``experiments``/``rois``/``blobs``/``blob_matches``,
database version 4), so databases interchange with the reference, and the
``ClrDB`` calls that write a truth ROI, list the ROIs, read confirmed
blobs or an ROI's blobs, and write and read blob matches between
channels.

Blob rows store x,y,z in database column order, but the API speaks z,y,x
blob arrays.
"""

from __future__ import annotations

import datetime
import os
import sqlite3
from typing import List, Optional, Sequence, Tuple

import numpy as np

from magellanmapper_torch.utils import libmag

DB_NAME = "magmap.db"
DB_VERSION = 4


def _create_db(path: str):
    if os.path.exists(path):
        libmag.backup_file(path)
    conn = sqlite3.connect(path)
    conn.row_factory = sqlite3.Row
    cur = conn.cursor()
    cur.execute(
        "CREATE TABLE about (version INTEGER PRIMARY KEY, date DATE)")
    cur.execute(
        "CREATE TABLE experiments (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "name TEXT, date DATE)")
    cur.execute(
        "CREATE TABLE rois (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "experiment_id INTEGER, series INTEGER, "
        "offset_x INTEGER, offset_y INTEGER, offset_z INTEGER, "
        "size_x INTEGER, size_y INTEGER, size_z INTEGER, "
        "UNIQUE (experiment_id, series, offset_x, offset_y, offset_z))")
    cur.execute(
        "CREATE TABLE blobs (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "roi_id INTEGER, x INTEGER, y INTEGER, z INTEGER, radius REAL, "
        "confirmed INTEGER, truth INTEGER, channel INTEGER, "
        "UNIQUE (roi_id, x, y, z, truth, channel))")
    cur.execute(
        "CREATE TABLE blob_matches (id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "roi_id INTEGER, blob1 INTEGER, blob2 INTEGER, dist REAL, "
        "FOREIGN KEY (roi_id) REFERENCES rois (id) "
        "ON UPDATE CASCADE ON DELETE CASCADE, "
        "FOREIGN KEY (blob1) REFERENCES blobs (id) "
        "ON UPDATE CASCADE ON DELETE CASCADE,"
        "FOREIGN KEY (blob2) REFERENCES blobs (id) "
        "ON UPDATE CASCADE ON DELETE CASCADE)")
    cur.execute("INSERT INTO about (version, date) VALUES (?, ?)",
                (DB_VERSION, datetime.datetime.now().isoformat()))
    conn.commit()
    return conn, cur


class ClrDB:
    """Database wrapper (reference ``sqlite.ClrDB``)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or DB_NAME
        self.conn: Optional[sqlite3.Connection] = None
        self.cur: Optional[sqlite3.Cursor] = None

    def load_db(self, path: Optional[str] = None) -> "ClrDB":
        if path:
            self.path = path
        if os.path.exists(self.path):
            self.conn = sqlite3.connect(self.path)
            self.conn.row_factory = sqlite3.Row
            self.cur = self.conn.cursor()
        else:
            self.conn, self.cur = _create_db(self.path)
        return self

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def select_or_insert_experiment(
            self, exp_name: str, date=None) -> int:
        self.cur.execute(
            "SELECT id FROM experiments WHERE name = ?", (exp_name,))
        row = self.cur.fetchone()
        if row:
            return row["id"]
        self.cur.execute(
            "INSERT INTO experiments (name, date) VALUES (?, ?)",
            (exp_name, date or datetime.datetime.now().isoformat()))
        self.conn.commit()
        return self.cur.lastrowid

    def select_or_insert_roi(
            self, exp_id: int, series: int, offset: Sequence[int],
            size: Sequence[int]) -> Tuple[int, str]:
        """offset/size given in x,y,z (DB convention)."""
        self.cur.execute(
            "SELECT id FROM rois WHERE experiment_id = ? AND series = ? "
            "AND offset_x = ? AND offset_y = ? AND offset_z = ?",
            (exp_id, series, *offset[:3]))
        row = self.cur.fetchone()
        if row:
            return row["id"], "exists"
        self.cur.execute(
            "INSERT INTO rois (experiment_id, series, offset_x, offset_y, "
            "offset_z, size_x, size_y, size_z) VALUES (?,?,?,?,?,?,?,?)",
            (exp_id, series, *offset[:3], *size[:3]))
        self.conn.commit()
        return self.cur.lastrowid, "inserted"

    def get_rois(self, exp_id: Optional[int] = None) -> List[sqlite3.Row]:
        """Every ROI's row, or those of one experiment."""
        if exp_id is None:
            self.cur.execute("SELECT * FROM rois")
        else:
            self.cur.execute(
                "SELECT * FROM rois WHERE experiment_id = ?", (exp_id,))
        return self.cur.fetchall()

    def insert_blobs(self, roi_id: int, blobs: np.ndarray) -> int:
        """Insert z,y,x blob rows."""
        rows = []
        for b in blobs:
            confirmed = b[4] if len(b) > 4 else -1
            truth = b[5] if len(b) > 5 else -1
            channel = b[6] if len(b) > 6 else 0
            rows.append((
                roi_id, int(round(b[2])), int(round(b[1])),
                int(round(b[0])), float(b[3]), int(confirmed), int(truth),
                int(channel)))
        self.cur.executemany(
            "INSERT OR REPLACE INTO blobs (roi_id, x, y, z, radius, "
            "confirmed, truth, channel) VALUES (?,?,?,?,?,?,?,?)", rows)
        self.conn.commit()
        return len(rows)

    def select_blobs_by_roi(self, roi_id: int) -> np.ndarray:
        """Blobs of an ROI as an N x 10 z,y,x array (absolute coordinates
        from the stored ones)."""
        self.cur.execute(
            "SELECT z, y, x, radius, confirmed, truth, channel "
            "FROM blobs WHERE roi_id = ?", (roi_id,))
        rows = self.cur.fetchall()
        if not rows:
            return np.zeros((0, 10))
        arr = np.array([[
            r["z"], r["y"], r["x"], r["radius"], r["confirmed"],
            r["truth"], r["channel"]] for r in rows], dtype=float)
        return np.column_stack([arr, arr[:, :3]])

    def delete_blobs(self, roi_id: int) -> None:
        self.cur.execute("DELETE FROM blobs WHERE roi_id = ?", (roi_id,))
        self.conn.commit()

    def insert_blob_matches(self, roi_id: int, matches) -> None:
        """Insert matches (a ``BlobMatch`` or ``(blob1, blob2, dist)``
        tuples), each blob named by the ID of its row in the ROI."""
        items = matches.df.iterrows() if hasattr(matches, "df") and \
            matches.df is not None else enumerate(matches)
        for _, m in items:
            if hasattr(m, "get"):
                b1 = m.get("Blob1")
                b2 = m.get("Blob2")
                dist = m.get("Distance")
            else:
                b1, b2, dist = m
            id1 = self._blob_id_for(roi_id, b1)
            id2 = self._blob_id_for(roi_id, b2)
            self.cur.execute(
                "INSERT INTO blob_matches (roi_id, blob1, blob2, dist) "
                "VALUES (?,?,?,?)", (roi_id, id1, id2, float(dist)))
        self.conn.commit()

    def _blob_id_for(self, roi_id: int, blob) -> Optional[int]:
        self.cur.execute(
            "SELECT id FROM blobs WHERE roi_id = ? AND x = ? AND y = ? "
            "AND z = ?",
            (roi_id, int(round(blob[2])), int(round(blob[1])),
             int(round(blob[0]))))
        row = self.cur.fetchone()
        return row["id"] if row else None

    def select_blob_matches(self, roi_id: int) -> List[Tuple]:
        """``(blob1 ID, blob2 ID, distance)`` of each match in an ROI."""
        self.cur.execute(
            "SELECT blob1, blob2, dist FROM blob_matches WHERE roi_id = ?",
            (roi_id,))
        return [tuple(r) for r in self.cur.fetchall()]

    def select_blobs_confirmed(self, confirmed: int) -> np.ndarray:
        """Blobs of every ROI with the given confirmation flag, as an
        N x 7 z,y,x array."""
        self.cur.execute(
            "SELECT z, y, x, radius, confirmed, truth, channel FROM blobs "
            "WHERE confirmed = ?", (confirmed,))
        rows = self.cur.fetchall()
        return np.array([[r[k] for k in (
            "z", "y", "x", "radius", "confirmed", "truth", "channel")]
            for r in rows], dtype=float).reshape(-1, 7)


def load_db(path: str) -> ClrDB:
    """Load or create a database at ``path``."""
    return ClrDB(path).load_db()


def load_truth_db(path: str) -> ClrDB:
    """Load a truth database (``.db`` is appended when missing)."""
    if not path.endswith(".db"):
        path = f"{path}.db"
    return load_db(path)
