"""The rest of the port's ``io/sqlite`` against the reference's: the same
calls on both packages' databases give the same rows (every table,
dates aside), each package reads what the other wrote, and
``verification_stats``, ``merge_truth_dbs``, ``upgrade_db`` from an
older schema, the ROI helpers and the name helpers return the same
values (exactly)."""

import sqlite3

import numpy as np
import pytest

from magellanmapper_tpu.io import sqlite as ref_sqlite
from magellanmapper_torch.io import sqlite

TABLES = ("about", "experiments", "rois", "blobs", "blob_matches")


def dump(path):
    """Every table's rows and columns, dates left out (they are the
    clock's)."""
    conn = sqlite3.connect(path)
    out = {}
    for table in TABLES:
        try:
            cur = conn.execute(f"SELECT * FROM {table} ORDER BY rowid")
        except sqlite3.OperationalError:
            out[table] = None
            continue
        cols = [d[0] for d in cur.description]
        out[table] = (cols, [tuple(v for c, v in zip(cols, row)
                                   if c != "date") for row in cur])
    out["schema"] = sorted(
        str(r[0]) for r in conn.execute("SELECT sql FROM sqlite_master"))
    conn.close()
    return out


def seeded_blobs(seed, n=12):
    rng = np.random.default_rng(seed)
    blobs = np.zeros((n, 10))
    blobs[:, :3] = rng.integers(0, 40, (n, 3))
    blobs[:, 3] = rng.random(n) * 4 + 1
    blobs[:, 4] = rng.choice([-1, 0, 1, 2], n)
    blobs[:, 5] = rng.choice([-1, 0, 1], n)
    blobs[:, 6] = rng.integers(0, 2, n)
    blobs[:, 7:] = blobs[:, :3] + 100
    return blobs


def session(sq, path):
    """A curation session through the module-level calls; returns what
    each call returned."""
    db = sq.load_db(path)
    conn, cur = db.conn, db.cur
    out = [sq.insert_experiment(conn, cur, "brain1", "2020-01-01")]
    exp2 = db.select_or_insert_experiment("brain2")
    out.append(sq.insert_roi(conn, cur, out[0], 0, (10, 20, 30), (40, 40, 8)))
    out.append(sq.select_or_insert_roi(conn, cur, out[0], 0, (10, 20, 30),
                                       (40, 40, 8)))
    out.append(sq.select_or_insert_roi(conn, cur, exp2, 1, (0, 0, 0),
                                       (16, 16, 4)))
    roi1, roi2 = out[1][0], out[3][0]
    out.append(sq.insert_blobs(conn, cur, roi1, seeded_blobs(0)))
    out.append(sq.insert_blobs(conn, cur, roi2, seeded_blobs(1, 5)))
    out.append(sq.delete_blobs(conn, cur, roi1, seeded_blobs(0)[:3]))
    out.append(sq.delete_blobs(conn, cur, roi1, [[999, 999, 999]]))
    for flag in (-1, 0, 1, 2):
        out.append(sq.select_blobs_confirmed(cur, flag))
    out.append(db.select_blobs_confirmed(1))
    out += [[tuple(r) for r in sq.select_rois(cur)],
            [tuple(r) for r in sq.select_rois(cur, exp2)],
            tuple(sq.select_roi(cur, roi2)), sq.select_roi(cur, 99),
            [tuple(r) for r in db.select_rois()],
            tuple(db.select_roi(roi1))]
    roi = db.select_roi(roi1)
    out += [sq.get_roi_offset(roi), sq.get_roi_size(roi),
            db.get_roi_offset(roi), db.get_roi_size(roi)]
    out.append(db.verification_stats())
    out.append(sq.verification_stats(db, "brain1"))
    out.append(sq.verification_stats(db, "brain1", treat_maybes=1))
    out.append(sq.verification_stats(db, "brain1", treat_maybes=2))
    out.append(sq.verification_stats(db, "nothing"))
    out.append(sq.update_rois(conn, cur, (5, 10, 15), (1, 2, 3)))
    out.append(db.update_rois((1, 1, 1), (0, 0, 0)))
    cur.execute("DELETE FROM rois WHERE id = ?", (roi2,))
    conn.commit()
    out.append(sq.clean_up_blobs(db))
    sq.insert_about(conn, cur, 5, "2021-02-03")
    out += [[tuple(r)[0] for r in sq.select_about(conn, cur)],
            [tuple(r)[0] for r in db.select_about()], db.db_version(),
            sq.upgrade_db(conn, cur), db.upgrade_db()]
    db.close()
    return out


def norm(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return v


def test_session_rows_and_returns_match_reference(tmp_path):
    port = session(sqlite, str(tmp_path / "port.db"))
    ref = session(ref_sqlite, str(tmp_path / "ref.db"))
    assert norm(port) == norm(ref)
    assert dump(str(tmp_path / "port.db")) == dump(str(tmp_path / "ref.db"))


@pytest.mark.parametrize("writer,reader", [
    (sqlite, ref_sqlite), (ref_sqlite, sqlite)])
def test_each_package_reads_the_others_database(tmp_path, writer, reader):
    path = str(tmp_path / "x.db")
    session(writer, path)
    db = writer.load_db(str(tmp_path / "w.db"))
    exp = db.select_or_insert_experiment("m")
    roi, _ = db.select_or_insert_roi(exp, 0, (1, 2, 3), (8, 8, 4))
    db.insert_blobs(roi, seeded_blobs(3))
    db.insert_blob_matches(roi, [(seeded_blobs(3)[0], seeded_blobs(3)[1],
                                  2.5)])
    db.close()
    for p in (path, str(tmp_path / "w.db")):
        got = reader.load_db(p)
        want = writer.load_db(p)
        assert got.db_version() == want.db_version()
        assert [tuple(r) for r in got.select_rois()] == [
            tuple(r) for r in want.select_rois()]
        for r in want.select_rois():
            np.testing.assert_array_equal(
                got.select_blobs_by_roi(r["id"]),
                want.select_blobs_by_roi(r["id"]))
            assert got.select_blob_matches(r["id"]) == \
                want.select_blob_matches(r["id"])
        assert got.verification_stats() == want.verification_stats()
        got.close()
        want.close()


def old_db(path, version):
    """A database of an older schema: version 1 has no ``about`` table,
    no blob channel and no ``blob_matches``; version 2 adds ``about``;
    version 3 the channel."""
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE experiments (id INTEGER PRIMARY KEY "
                 "AUTOINCREMENT, name TEXT, date DATE)")
    conn.execute("CREATE TABLE rois (id INTEGER PRIMARY KEY AUTOINCREMENT, "
                 "experiment_id INTEGER, series INTEGER, offset_x INTEGER, "
                 "offset_y INTEGER, offset_z INTEGER, size_x INTEGER, "
                 "size_y INTEGER, size_z INTEGER)")
    chan = ", channel INTEGER" if version >= 3 else ""
    conn.execute("CREATE TABLE blobs (id INTEGER PRIMARY KEY AUTOINCREMENT, "
                 "roi_id INTEGER, x INTEGER, y INTEGER, z INTEGER, "
                 f"radius REAL, confirmed INTEGER, truth INTEGER{chan})")
    if version >= 2:
        conn.execute("CREATE TABLE about (version INTEGER PRIMARY KEY, "
                     "date DATE)")
        conn.execute("INSERT INTO about VALUES (?, '2015-01-01')",
                     (version,))
    conn.execute("INSERT INTO experiments (name, date) VALUES ('e', 'd')")
    conn.execute("INSERT INTO rois (experiment_id, series, offset_x, "
                 "offset_y, offset_z, size_x, size_y, size_z) VALUES "
                 "(1, 0, 1, 2, 3, 10, 10, 5)")
    conn.execute("INSERT INTO blobs (roi_id, x, y, z, radius, confirmed, "
                 "truth) VALUES (1, 4, 5, 2, 2.5, 1, -1)")
    conn.commit()
    conn.close()


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_upgrade_from_older_versions_matches_reference(tmp_path, version):
    outs = []
    for sq, name in ((sqlite, "port"), (ref_sqlite, "ref")):
        path = str(tmp_path / f"{name}.db")
        if version < 4:
            old_db(path, version)
        db = sq.load_db(path)
        outs.append((db.db_version(), db.upgrade_db(), db.db_version(),
                     db.upgrade_db()))
        outs.append(db.select_blobs_by_roi(1))
        db.close()
        outs.append(dump(path))
    assert outs[0] == outs[3]
    np.testing.assert_array_equal(outs[1], outs[4])
    assert repr(outs[2]) == repr(outs[5])


def test_merge_truth_dbs_matches_reference(tmp_path):
    for sq in (sqlite, ref_sqlite):
        name = sq.__name__.split(".")[0]
        for i, (exp, off) in enumerate((("a", (0, 0, 0)), ("b", (5, 5, 5)),
                                        ("a", (0, 0, 0)))):
            db = sq.load_db(str(tmp_path / f"{name}_{i}.db"))
            eid = db.select_or_insert_experiment(exp)
            roi, _ = db.select_or_insert_roi(eid, 0, off, (20, 20, 10))
            db.insert_blobs(roi, seeded_blobs(10 + i, 6))
            db.close()
        out = sq.merge_truth_dbs([str(tmp_path / f"{name}_{i}.db")
                                  for i in range(3)],
                                 str(tmp_path / f"{name}_merged.db"))
        assert out.verification_stats() == sq.load_db(
            str(tmp_path / f"{name}_merged.db")).verification_stats()
        out.close()
    port = dump(str(tmp_path / "magellanmapper_torch_merged.db"))
    ref = dump(str(tmp_path / "magellanmapper_tpu_merged.db"))
    assert port == ref
    assert len(port["blobs"][1]) > 6


@pytest.mark.parametrize("path", [
    "/d/brain.npy", "/d/brain_(10,20,30)x(40,50,60).npy",
    "brain.tif", "/d/sub/b_image5d.npy", ""])
def test_name_helpers_match_reference(path):
    assert sqlite.get_exp_name(path) == ref_sqlite.get_exp_name(path)
    for src, delim in ((path, "/"), ("a,b,c", ","), ("x", ",")):
        assert sqlite.match_elements(src, delim, "?") == \
            ref_sqlite.match_elements(src, delim, "?")
