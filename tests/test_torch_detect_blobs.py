"""``magellanmapper_torch.cv.detector.detect_blobs`` and the preprocessing
it adds (``ops.preproc.otsu_threshold``, ``spectral_unmix``) against the
reference on seeded inputs: blob rows equal (``testing.rows_equal``:
coordinates and columns exact, radii within 1e-6 relative), Otsu
thresholds equal, unmixing within 1e-6."""

import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.ops import preproc as ref_preproc
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_torch import testing
from magellanmapper_torch.cv import detector
from magellanmapper_torch.ops import preproc
from magellanmapper_torch.settings.roi_prof import ROIProfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_detector import make_synthetic_nuclei  # noqa: E402

torch.set_num_threads(1)


def _profiles(**overrides):
    """The port's and the reference's profile of ``test_detector.py``."""
    out = []
    for cls in (ROIProfile, RefProfile):
        prof = cls()
        prof.update(min_sigma_factor=2.0, max_sigma_factor=4.0, num_sigma=5)
        prof.update(overrides)
        out.append(prof)
    return out


#: the fixtures of tests/test_detector.py::TestDetectBlobs, plus
#: preprocessing and a z-anisotropic isotropic resample that shrinks
CASES = {
    "full_surface": (dict(n=20), {}, (1.0, 1.0, 1.0), {}),
    "exclude_border": (dict(n=30), {}, (1, 1, 1),
                       dict(exclude_border=(10, 10, 10))),
    "isotropic_repositioning": (dict(shape=(24, 64, 64), n=10),
                                dict(isotropic=(1.0, 1.0, 1.0)),
                                (2.0, 1.0, 1.0), {}),
    "isotropic_shrink": (dict(shape=(24, 64, 64), n=10),
                         dict(isotropic=(0.5, 0.5, 0.5)),
                         (1.0, 1.0, 1.0), {}),
    "preprocess": (dict(n=20), {}, (1.0, 1.0, 1.0),
                   dict(preprocess=True, near_max=[0.8])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detect_blobs_matches_reference(name):
    fixture, prof_kw, res, kwargs = CASES[name]
    vol, _ = make_synthetic_nuclei(**fixture)
    prof, ref_prof = _profiles(**prof_kw)
    want = ref_detector.detect_blobs(vol, ref_prof, res, **kwargs)
    got = detector.detect_blobs(vol, prof, res, device="cpu", **kwargs)
    assert want is not None and len(want) > 0
    assert testing.rows_equal(got, want), (
        None if got is None else got.shape, want.shape)


def test_detect_blobs_multichannel_unmixing_matches_reference():
    a, _ = make_synthetic_nuclei(seed=1, shape=(32, 48, 48), n=12)
    b, _ = make_synthetic_nuclei(seed=2, shape=(32, 48, 48), n=12)
    roi = np.stack([a, 0.5 * a + b], axis=-1)
    prof, ref_prof = _profiles(spectral_unmixing={1: {0: 0.5}})
    want = ref_detector.detect_blobs(roi, ref_prof, (1.0, 1.0, 1.0))
    got = detector.detect_blobs(roi, prof, (1.0, 1.0, 1.0), device="cpu")
    assert set(want[:, 6]) == {0.0, 1.0}
    assert testing.rows_equal(got, want)
    for ch in (0, 1):
        want = ref_detector.detect_blobs(roi, ref_prof, (1.0, 1.0, 1.0),
                                         channel=[ch])
        got = detector.detect_blobs(roi, prof, (1.0, 1.0, 1.0),
                                    channel=[ch], device="cpu")
        assert testing.rows_equal(got, want)


def test_detect_blobs_empty_block():
    prof, ref_prof = _profiles()
    vol = np.zeros((16, 16, 16), np.float32)
    assert ref_detector.detect_blobs(vol, ref_prof, (1, 1, 1)) is None
    assert detector.detect_blobs(vol, prof, (1, 1, 1), device="cpu") is None


def test_detect_blobs_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prof, _ = _profiles()
    with pytest.raises(RuntimeError, match="CUDA"):
        detector.detect_blobs(np.zeros((8, 8, 8), np.float32), prof,
                              (1, 1, 1))


def _otsu_inputs():
    rng = np.random.default_rng(7)
    out = []
    for i in range(8):
        vol = (rng.random((20, 30, 25)) ** (1 + i % 4)).astype(np.float32)
        vol *= 1 + 100 * i
        if i % 3 == 0:
            vol[:5] = 0
        out.append(vol)
    out.append(rng.integers(0, 4000, (16, 40, 40)).astype(np.uint16))
    out.append(np.full((6, 6, 6), 3.5, np.float32))   # one value
    return out


@pytest.mark.parametrize("i", range(10))
def test_otsu_threshold_matches_reference(i):
    vol = _otsu_inputs()[i]
    want = float(ref_preproc.otsu_threshold(jnp.asarray(vol)))
    got = float(preproc.otsu_threshold(torch.from_numpy(
        vol.astype(np.float32))))
    assert got == want


def test_otsu_counts_past_2_24_in_a_bin_pin():
    """Recorded deviation (ROADMAP §3): the reference counts with float32
    scatter-adds, which stop at 2^24 = 16,777,216 in a bin; a 20 M-voxel
    bin is counted exactly by the port's integer histogram."""
    n = 20_000_000
    saturated = jnp.zeros(1).at[jnp.zeros(n, jnp.int32)].add(1.0)
    assert float(saturated[0]) == 16_777_216.0
    vol = torch.zeros(n)
    vol[-1] = 1.0
    counts, lo, span = preproc._histogram(vol, 256)
    assert int(counts[0]) == n - 1 and int(counts[-1]) == 1
    assert float(lo) == 0.0 and float(span) == 1.0


def test_spectral_unmix_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.random((6, 7, 8)).astype(np.float32)
    b = rng.random((6, 7, 8)).astype(np.float32)
    want = np.asarray(ref_preproc.spectral_unmix(
        jnp.asarray(a), jnp.asarray(b), 0.7))
    got = preproc.spectral_unmix(torch.from_numpy(a), torch.from_numpy(b),
                                 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.min() == 0.0
