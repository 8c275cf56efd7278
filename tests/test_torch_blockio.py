"""``io._blockio.extract_blocks`` (``csrc/host/blockio.cpp``, built with
g++ at first use) against the reference's ``native.extract_blocks`` and
numpy slicing, on memmaps of every type the library reads; its errors;
and the detect path's single-window route through it.

Tolerance: none. Both libraries cast each value to float32 in C++, as
numpy's ``astype`` does, so the batches are equal bit for bit, and the
blobs of the retry route through the extractor equal the resident
route's.
"""

import numpy as np
import pytest

from magellanmapper_tpu import native as ref_native
from magellanmapper_torch.cv import stack_detect as sd
from magellanmapper_torch.io import _blockio, _hostbuild
from magellanmapper_torch.testing import make_nuclei_volume, rows_equal

SHAPE = (23, 37, 41)
BLOCK = (7, 16, 19)


def _volume(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        vol = rng.normal(0, 1000, SHAPE)
        vol[0, 0, :3] = (np.inf, -np.inf, np.nan)
        # past float32's range: both casts give infinity
        vol[1, 1, :2] = (1e39, -0.0)
    else:
        info = np.iinfo(dtype)
        vol = rng.integers(info.min, info.max, SHAPE, endpoint=True,
                           dtype=np.int64 if info.max < 2**63 else None)
    with np.errstate(over="ignore"):
        return vol.astype(dtype)


def _starts(seed=1, n=9):
    rng = np.random.default_rng(seed)
    hi = np.asarray(SHAPE) - BLOCK
    starts = rng.integers(0, hi + 1, (n, 3))
    starts[0] = 0
    starts[1] = hi
    return starts


def _memmap(tmp_path, vol):
    path = str(tmp_path / "vol.npy")
    np.save(path, vol)
    return np.load(path, mmap_mode="r")


@pytest.mark.parametrize("dtype", sorted(_blockio.DTYPES, key=str))
def test_extract_blocks_matches_reference_on_memmaps(tmp_path, dtype):
    vol = _memmap(tmp_path, _volume(dtype))
    starts = _starts()
    got = _blockio.extract_blocks(vol, starts, BLOCK)
    want = ref_native.extract_blocks(vol, starts, BLOCK)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with np.errstate(over="ignore"):
        slices = np.stack([np.asarray(vol[z:z + BLOCK[0], y:y + BLOCK[1],
                                          x:x + BLOCK[2]], np.float32)
                           for z, y, x in starts])
    np.testing.assert_array_equal(got.view(np.uint32),
                                  slices.view(np.uint32))


@pytest.mark.parametrize("view", ["flipped", "strided", "transposed"])
@pytest.mark.parametrize("n_threads", [1, 3, None])
def test_extract_blocks_of_views_and_threads(tmp_path, view, n_threads):
    base = _memmap(tmp_path, _volume(np.uint16, 2))
    vol = {"flipped": base[::-1, :, ::-1],
           "strided": base[:, ::2, :][:, :, 1:],
           "transposed": base.transpose(2, 1, 0)}[view]
    block = tuple(min(b, s) for b, s in zip(BLOCK, vol.shape))
    hi = np.asarray(vol.shape) - block
    starts = np.stack([np.zeros(3, int), hi, hi // 2])
    out = np.full((3,) + block, -1, np.float32)
    got = _blockio.extract_blocks(vol, starts, block, out=out,
                                  n_threads=n_threads)
    assert got is out
    np.testing.assert_array_equal(
        got, ref_native.extract_blocks(vol, starts, block))


def test_no_windows_gives_an_empty_batch(tmp_path):
    vol = _memmap(tmp_path, _volume(np.float32))
    got = _blockio.extract_blocks(vol, np.zeros((0, 3), int), BLOCK)
    assert got.shape == (0,) + BLOCK and got.dtype == np.float32


@pytest.mark.parametrize("vol,starts,kwargs,match", [
    (np.zeros(SHAPE, np.int8), [[0, 0, 0]], {}, "3D volumes of"),
    (np.zeros(SHAPE, np.uint64), [[0, 0, 0]], {}, "3D volumes of"),
    (np.zeros((2,) + SHAPE, np.float32), [[0, 0, 0]], {}, "not a 4D"),
    (np.zeros(SHAPE, np.float32), [[-1, 0, 0]], {}, "leaves the volume"),
    (np.zeros(SHAPE, np.float32), [[17, 0, 0]], {}, "leaves the volume"),
    (np.zeros(SHAPE, np.float32), [[0, 0, 0]],
     {"out": np.zeros((1,) + BLOCK, np.float64)}, "C-contiguous float32"),
    (np.zeros(SHAPE, np.float32), [[0, 0, 0]],
     {"out": np.zeros((2,) + BLOCK, np.float32)}, "C-contiguous float32"),
])
def test_what_the_library_cannot_read_raises(vol, starts, kwargs, match):
    """Where the reference falls back to a numpy loop (a type outside its
    table) or reads out of bounds, the port raises."""
    with pytest.raises(ValueError, match=match):
        _blockio.extract_blocks(vol, np.asarray(starts), BLOCK, **kwargs)


def test_no_numpy_fallback_when_the_build_fails(tmp_path, monkeypatch):
    vol = _volume(np.float32)
    monkeypatch.setattr(_blockio, "_lib", None)
    monkeypatch.setattr(_blockio, "_BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.setattr(_hostbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        _blockio.extract_blocks(vol, _starts(), BLOCK)


def test_a_failed_call_raises(monkeypatch):
    class _Failing:
        @staticmethod
        def blockio_extract(*args):
            return 1

    monkeypatch.setattr(_blockio, "library", lambda: _Failing)
    with pytest.raises(RuntimeError, match="failed with code 1"):
        _blockio.extract_blocks(_volume(np.float32), _starts(), BLOCK)


def test_library_builds_under_build_host():
    path = _blockio.build()
    assert path.exists() and path.parent.name == "host"
    assert path == _blockio.library_path()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_single_window_route_reads_through_the_extractor(dtype, monkeypatch):
    """The gather route (past the resident budget, and the overflow
    retry) reads wider volumes through ``extract_blocks``: its blobs equal
    the resident route's, and every window was extracted."""
    vol = make_nuclei_volume((40, 140, 140), seed=3)[0].astype(dtype)
    prof = sd.roi_profile("lightsheet")
    want, _ = sd.detect_blobs_blocks(vol, prof, (1.0, 1.0, 1.0),
                                     device="cpu")
    calls = []
    real = _blockio.extract_blocks

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(sd._blockio, "extract_blocks", counted)
    monkeypatch.setattr(sd, "_RESIDENT_BYTES_BUDGET", 0)
    monkeypatch.setattr(sd, "_plan_slabs", lambda *a, **k: None)
    got, _ = sd.detect_blobs_blocks(vol, prof, (1.0, 1.0, 1.0),
                                    device="cpu")
    assert want is not None and len(want) > 10
    assert rows_equal(got, want)
    assert calls and all(len(s) == 1 for s in calls)
