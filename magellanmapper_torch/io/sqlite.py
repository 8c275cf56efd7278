"""Blob/ROI/truth database (sqlite3) in the reference's schema.

Copy of ``magellanmapper_tpu/io/sqlite.py``: the same tables
(``about``/``experiments``/``rois``/``blobs``/``blob_matches``, database
version 4), so databases interchange with the reference; the ``ClrDB``
wrapper (ROIs, blobs, blob matches, verification counts, the version
and its upgrade); the module-level ``(conn, cur)`` calls of the
reference's API; and truth-database loading and merging.

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

    def verification_stats(self) -> Tuple[int, int, int]:
        """``(pos, true_pos, false_pos)``: blobs with a truth flag, blobs
        confirmed without one, and blobs marked incorrect."""
        self.cur.execute(
            "SELECT COUNT(*) AS n FROM blobs WHERE truth >= 0")
        pos = self.cur.fetchone()["n"]
        self.cur.execute(
            "SELECT COUNT(*) AS n FROM blobs WHERE confirmed = 1 AND "
            "truth = -1")
        true_pos = self.cur.fetchone()["n"]
        self.cur.execute(
            "SELECT COUNT(*) AS n FROM blobs WHERE confirmed = 0")
        false_pos = self.cur.fetchone()["n"]
        return pos, true_pos, false_pos

    def select_about(self) -> list:
        self.cur.execute("SELECT * FROM about")
        return self.cur.fetchall()

    def db_version(self) -> int:
        """The newest version in ``about``; 0 for a database without
        that table."""
        try:
            rows = self.select_about()
            return int(rows[-1]["version"]) if rows else 0
        except sqlite3.OperationalError:
            return 0

    def upgrade_db(self) -> int:
        """Bring an older database to the current schema: the ``about``
        table (version 2), the blobs' channel column (3) and the
        ``blob_matches`` table (4). Returns the version reached."""
        ver = self.db_version()
        if ver >= DB_VERSION:
            return ver
        if ver < 2:
            try:
                self.cur.execute(
                    "CREATE TABLE about "
                    "(version INTEGER PRIMARY KEY, date DATE)")
            except sqlite3.OperationalError:
                pass
        if ver < 3:
            cols = [r["name"] for r in self.cur.execute(
                "PRAGMA table_info(blobs)")]
            if "channel" not in cols:
                self.cur.execute(
                    "ALTER TABLE blobs ADD COLUMN channel INTEGER "
                    "DEFAULT 0")
        if ver < 4:
            self.cur.execute(
                "CREATE TABLE IF NOT EXISTS blob_matches "
                "(id INTEGER PRIMARY KEY AUTOINCREMENT, roi_id INTEGER, "
                "blob1 INTEGER, blob2 INTEGER, dist REAL)")
        self.cur.execute(
            "INSERT INTO about (version, date) VALUES (?, ?)",
            (DB_VERSION, datetime.datetime.now().isoformat()))
        self.conn.commit()
        return DB_VERSION

    def select_rois(self, exp_id: Optional[int] = None) -> list:
        return self.get_rois(exp_id)

    def select_roi(self, roi_id: int):
        """One ROI's row by its ID."""
        self.cur.execute("SELECT * FROM rois WHERE id = ?", (roi_id,))
        return self.cur.fetchone()

    def update_rois(self, offset, size) -> int:
        """Shift every ROI's offset by ``-offset`` and grow its size by
        ``size`` (both x,y,z); returns the ROIs updated."""
        self.cur.execute("SELECT * FROM rois")
        rows = self.cur.fetchall()
        for row in rows:
            self.cur.execute(
                "UPDATE rois SET offset_x = ?, offset_y = ?, offset_z = ?, "
                "size_x = ?, size_y = ?, size_z = ? WHERE id = ?",
                (row["offset_x"] - offset[0], row["offset_y"] - offset[1],
                 row["offset_z"] - offset[2], row["size_x"] + size[0],
                 row["size_y"] + size[1], row["size_z"] + size[2],
                 row["id"]))
        self.conn.commit()
        return len(rows)

    def get_roi_offset(self, roi) -> tuple:
        return get_roi_offset(roi)

    def get_roi_size(self, roi) -> tuple:
        return get_roi_size(roi)


def load_db(path: str) -> ClrDB:
    """Load or create a database at ``path``."""
    return ClrDB(path).load_db()


def load_truth_db(path: str) -> ClrDB:
    """Load a truth database (``.db`` is appended when missing)."""
    if not path.endswith(".db"):
        path = f"{path}.db"
    return load_db(path)



def merge_truth_dbs(paths: Sequence[str], out_path: str) -> ClrDB:
    """Merge truth databases into one at ``out_path``: each source's
    experiments and ROIs by name and position, with their blobs."""
    out = load_db(out_path)
    for path in paths:
        src = load_db(path)
        src.cur.execute(
            "SELECT e.name, r.series, r.offset_x, r.offset_y, r.offset_z, "
            "r.size_x, r.size_y, r.size_z, r.id AS roi_id "
            "FROM rois r JOIN experiments e ON r.experiment_id = e.id")
        for roi in src.cur.fetchall():
            exp_id = out.select_or_insert_experiment(roi["name"])
            roi_id, _ = out.select_or_insert_roi(
                exp_id, roi["series"],
                (roi["offset_x"], roi["offset_y"], roi["offset_z"]),
                (roi["size_x"], roi["size_y"], roi["size_z"]))
            blobs = src.select_blobs_by_roi(roi["roi_id"])
            if len(blobs):
                out.insert_blobs(roi_id, blobs)
        src.close()
    return out


def get_exp_name(path: str) -> str:
    """Experiment name of an image path: its base name without the
    extension and the sub-image suffix."""
    from magellanmapper_torch.io import importer
    base = importer.deconstruct_img_name(path)[0]
    return os.path.splitext(os.path.basename(base))[0] if base else base


def match_elements(src: str, delim: str, repeat: str) -> str:
    """``repeat`` once per ``delim``-separated element of ``src``."""
    return delim.join([repeat] * len(src.split(delim)))


# -- module-level (conn, cur) calls, the reference's API ---------------------

def _db_for(conn, cur) -> ClrDB:
    db = ClrDB()
    db.conn = conn
    db.cur = cur
    return db


def insert_about(conn, cur, version: int, date) -> None:
    cur.execute("INSERT INTO about (version, date) VALUES (?, ?)",
                (version, date))
    conn.commit()


def select_about(conn, cur) -> list:
    return _db_for(conn, cur).select_about()


def upgrade_db(conn, cur) -> int:
    """Upgrade an older database in place (:meth:`ClrDB.upgrade_db`)."""
    return _db_for(conn, cur).upgrade_db()


def insert_experiment(conn, cur, name: str, date=None) -> int:
    cur.execute("INSERT INTO experiments (name, date) VALUES (?, ?)",
                (name, date or datetime.datetime.now().isoformat()))
    conn.commit()
    return cur.lastrowid


def insert_roi(conn, cur, exp_id: int, series: int, offset, size):
    """Insert an ROI's row, or find it (offset and size in x,y,z)."""
    return _db_for(conn, cur).select_or_insert_roi(
        exp_id, series, offset, size)


select_or_insert_roi = insert_roi


def insert_blobs(conn, cur, roi_id: int, blobs) -> int:
    return _db_for(conn, cur).insert_blobs(roi_id, np.asarray(blobs))


def delete_blobs(conn, cur, roi_id: int, blobs) -> int:
    """Delete the ROI's blobs at the given z,y,x coordinates; returns the
    rows deleted."""
    deleted = 0
    for blob in blobs:
        cur.execute(
            "DELETE FROM blobs WHERE roi_id = ? AND z = ? AND y = ? "
            "AND x = ?",
            (roi_id, int(round(blob[0])), int(round(blob[1])),
             int(round(blob[2]))))
        deleted += cur.rowcount
    conn.commit()
    return deleted


def select_blobs_confirmed(cur, confirmed: int) -> np.ndarray:
    return _db_for(None, cur).select_blobs_confirmed(confirmed)


def verification_stats(db: ClrDB, exp_name: str, treat_maybes: int = 0):
    """Sensitivity, PPV and message of an experiment's verified blobs
    (``verifier.meas_detection_accuracy``); Nones when it has none."""
    from magellanmapper_torch.cv import verifier
    exp_id = db.select_or_insert_experiment(exp_name)
    parts = [db.select_blobs_by_roi(roi["id"])
             for roi in db.get_rois(exp_id)]
    parts = [p for p in parts if len(p)]
    if not parts:
        return None, None, None
    return verifier.meas_detection_accuracy(
        np.vstack(parts), verified=True, treat_maybes=treat_maybes)


def select_rois(cur, exp_id: Optional[int] = None) -> list:
    return _db_for(None, cur).get_rois(exp_id)


def select_roi(cur, roi_id: int):
    return _db_for(None, cur).select_roi(roi_id)


def update_rois(conn, cur, offset, size) -> int:
    return _db_for(conn, cur).update_rois(offset, size)


def get_roi_offset(roi) -> Tuple[int, int, int]:
    """x,y,z offset of an ROI's row."""
    return (roi["offset_x"], roi["offset_y"], roi["offset_z"])


def get_roi_size(roi) -> Tuple[int, int, int]:
    """x,y,z size of an ROI's row."""
    return (roi["size_x"], roi["size_y"], roi["size_z"])


def clean_up_blobs(db: ClrDB) -> int:
    """Delete the blobs whose ROI no longer exists; returns the rows
    deleted."""
    db.cur.execute(
        "DELETE FROM blobs WHERE roi_id NOT IN (SELECT id FROM rois)")
    db.conn.commit()
    return db.cur.rowcount
