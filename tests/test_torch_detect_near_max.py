"""``detect_blobs_blocks``' ``near_max`` and ``verify_fn`` against the JAX
reference, both on the CPU (the port through its kernels' plain
versions): the same seeded volumes with a caller-given near-max, by
keyword and by position, the verification callback's stats, and
``detect_blobs_stack`` forwarding ``near_max``.

Blob rows must be equal after sorting (``testing.rows_equal``:
coordinates exact, radii within 1e-6 relative).
"""

import numpy as np
import pytest
import torch

from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.cv import verifier as ref_verifier
from magellanmapper_tpu.settings.roi_prof import ROIProfile
from magellanmapper_torch.cv import stack_detect as sd
from magellanmapper_torch.cv.blobs import Blobs
from magellanmapper_torch.cv import verifier
from magellanmapper_torch.testing import (
    make_nuclei_volume, rows_equal, sens_ppv)

torch.set_num_threads(1)

RES = (1.0, 1.0, 1.0)
SHAPE = (48, 192, 192)
TOL = (3, 3, 3)


def _lightsheet():
    prof = ROIProfile()
    prof.add_profiles("lightsheet")
    return prof


def _measured(vol):
    """The near-max both packages measure when none is given."""
    return float(np.percentile(vol[::max(1, vol.shape[0] // 16)], 99.5))


@pytest.fixture(scope="module")
def one():
    vol, centres = make_nuclei_volume(SHAPE, seed=0)
    return vol, centres, _measured(vol)


@pytest.fixture(scope="module")
def two():
    """Two channels; channel 1 its own seed."""
    vol = np.stack([make_nuclei_volume(SHAPE, seed=s)[0] for s in (1, 2)],
                   axis=-1)
    return vol, [_measured(vol[..., c]) for c in range(2)]


@pytest.fixture(scope="module")
def measured_rows(one):
    vol, _, _ = one
    got, _ = sd.detect_blobs_blocks(vol, _lightsheet(), RES, device="cpu")
    return got


@pytest.fixture(scope="module")
def ref_half(one):
    """The reference's rows at half the measured near-max, called by
    position: ``(image, settings, resolutions, channels, near_max,
    preprocess)``."""
    vol, _, nm = one
    want, _ = ref_sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, None, [nm / 2], True)
    assert want is not None and len(want) > 100
    return want


@pytest.fixture(scope="module")
def port_half(one):
    vol, _, nm = one
    got, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, near_max=[nm / 2], device="cpu")
    return got


def test_explicit_near_max_matches_reference(ref_half, port_half,
                                             measured_rows):
    """A halved near-max saturates at another level: the reference's rows,
    not those of the measured near-max."""
    assert rows_equal(port_half, ref_half)
    assert not rows_equal(port_half, measured_rows)


def test_measured_near_max_given_equals_measured(one, measured_rows):
    vol, _, nm = one
    got, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, near_max=[nm], device="cpu")
    assert rows_equal(got, measured_rows)


def test_two_channel_near_max_read_by_channel_number(two):
    """``channels=[1]`` reads ``near_max[1]``, as the reference does."""
    vol, nms = two
    near_max = [nms[0] * 4, nms[1] / 2]
    want, _ = ref_sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, channels=[1], near_max=near_max)
    got, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, channels=[1], near_max=near_max,
        device="cpu")
    assert want is not None and len(want) > 100
    assert rows_equal(got, want)
    assert np.all(Blobs.get_blobs_channel(got) == 1)
    measured, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, channels=[1], device="cpu")
    assert not rows_equal(got, measured)


def test_positional_call_binds_as_the_reference(one, ref_half, port_half):
    """``(image, settings, resolutions, channels, near_max, preprocess,
    verify_fn, device)`` by position, as the reference binds its first
    seven."""
    vol, _, nm = one
    got, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, None, [nm / 2], True, None, "cpu")
    assert rows_equal(got, ref_half)
    assert rows_equal(got, port_half)


def test_positional_preprocess_false_skips_preprocessing(one, port_half):
    """The sixth positional argument is ``preprocess``: ``False`` there
    detects on the raw volume, whatever the near-max. (Held to the port's
    keyword call: on this raw uint16 volume the reference finds 2 of ~1,490
    blobs fewer, noise peaks at a corner where the two packages' LoG sums
    round in another order.)"""
    vol, _, nm = one
    got, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, None, [nm / 2], False, None, "cpu")
    by_name, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, preprocess=False, device="cpu")
    assert rows_equal(got, by_name)
    assert not rows_equal(got, port_half)


def test_verify_fn_stats_match_reference(one):
    vol, centres, _ = one
    truth = np.column_stack([centres, np.full(len(centres), 3.0)])
    calls = []

    def port_fn(blobs):
        calls.append(len(blobs))
        return verifier.verify_stack(blobs, truth, TOL)

    want_blobs, want = ref_sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, verify_fn=lambda b: ref_verifier.verify_stack(
            b, truth, TOL))
    got_blobs, got = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, verify_fn=port_fn, device="cpu")
    assert calls == [len(got_blobs)]
    assert got["verify_stats"] == want["verify_stats"]
    sens, ppv, _ = got["verify_stats"]
    assert sens > 0.85 and ppv > 0.7
    assert rows_equal(got_blobs, want_blobs)


def test_verify_fn_not_called_without_blobs():
    """An empty volume: no blobs, no callback, no ``verify_stats``."""
    vol = np.zeros((24, 96, 96), np.uint16)
    calls = []
    _, want = ref_sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, verify_fn=calls.append)
    blobs, got = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, verify_fn=calls.append, device="cpu")
    assert blobs is None and calls == []
    assert "verify_stats" not in got and "verify_stats" not in want


def test_detect_blobs_stack_forwards_near_max(one, ref_half, port_half):
    """One channel group: the stack's rows are the group's block rows at
    the given near-max, the reference's."""
    vol, centres, nm = one
    got, _ = sd.detect_blobs_stack(
        vol, _lightsheet(), RES, near_max=[nm / 2], device="cpu")
    assert np.array_equal(got.blobs, port_half)
    assert rows_equal(got.blobs, ref_half)
    sens, ppv = sens_ppv(got.blobs, centres, SHAPE, SHAPE, TOL)
    assert sens > 0.5 and ppv > 0.5


def test_raw_volume_without_preprocessing_differs_at_corner_noise_pin(one):
    """Pin: without preprocessing, on the raw uint16 volume, the port finds
    the reference's rows and 2 more, noise peaks on the first plane's last
    row, where the LoG sums of the two packages round in another order
    (ROADMAP section 3)."""
    vol, _, _ = one
    want, _ = ref_sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, preprocess=False)
    got, _ = sd.detect_blobs_blocks(
        vol, _lightsheet(), RES, preprocess=False, device="cpu")
    keys = {tuple(r) for r in want[:, :3]}
    extra = np.asarray([r for r in got if tuple(r[:3]) not in keys])
    assert len(got) == len(want) + 2 and len(extra) == 2
    assert rows_equal(np.asarray([r for r in got if tuple(r[:3]) in keys]),
                      want)
    assert np.all(extra[:, 0] == 0) and np.all(extra[:, 1] == SHAPE[1] - 1)
