"""The port's JPEG 2000 binding (``io.jp2k``) against the reference's.

Both bind the system libopenjp2 through ctypes (skipped by name without
it): each package decodes the other's codestreams to the same arrays,
their encoders write the same bytes, and bad input raises the same
exception with the same message. Without the library both raise
``ImportError`` naming it.
"""

import numpy as np
import pytest

from magellanmapper_torch import testing
from magellanmapper_torch.io import jp2k
from magellanmapper_tpu.io import jp2k as ref_jp2k

pytestmark = pytest.mark.skipif(
    not ref_jp2k.available(), reason="no system libopenjp2")


def _images():
    rng = np.random.default_rng(2)
    return {
        "uint16": rng.integers(0, 60000, (32, 40), dtype=np.uint16),
        "uint8": rng.integers(0, 255, (24, 32), dtype=np.uint8),
        "two_components": rng.integers(0, 255, (16, 20, 2), dtype=np.uint8),
        "three_components": rng.integers(0, 4000, (9, 11, 3),
                                         dtype=np.uint16),
        "int16": rng.integers(-3000, 3000, (12, 14), dtype=np.int16),
    }


@pytest.mark.parametrize("codec", ["J2K", "JP2"])
@pytest.mark.parametrize("name", list(_images()))
def test_codestreams_equal_and_decode_each_other(name, codec):
    img = _images()[name]
    fmt = getattr(jp2k, f"OPJ_CODEC_{codec}")
    got = testing.same_outcome(
        lambda: ref_jp2k.encode(img, codec_format=fmt, num_resolutions=3),
        lambda: jp2k.encode(img, codec_format=fmt, num_resolutions=3))
    if isinstance(got, tuple):  # both refused this image
        return
    assert got[:12] == jp2k.JP2_SIGNATURE if codec == "JP2" else \
        got[:4] == jp2k.J2K_SOC
    out = testing.same_outcome(lambda: ref_jp2k.decode(got),
                               lambda: jp2k.decode(got))
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("data", [
    b"definitely not jpeg2000 bytes",
    jp2k.J2K_SOC + b"\x00" * 40,
    jp2k.JP2_SIGNATURE + b"\x00" * 40])
def test_bad_input_raises_as_reference(data):
    out = testing.same_outcome(lambda: ref_jp2k.decode(data),
                               lambda: jp2k.decode(data))
    assert out[0] == "ValueError"


def test_truncated_codestream_raises_as_reference():
    enc = ref_jp2k.encode(_images()["uint16"], num_resolutions=3)
    for cut in (len(enc) // 3, len(enc) - 8):
        testing.same_outcome(lambda: ref_jp2k.decode(enc[:cut]),
                             lambda: jp2k.decode(enc[:cut]))


def test_without_libopenjp2_both_raise_by_name(monkeypatch):
    for mod in (jp2k, ref_jp2k):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_tried", True)
    img = _images()["uint8"]
    for call in (lambda m: m.decode(b"\xff\x4f\xff\x51"),
                 lambda m: m.encode(img)):
        out = testing.same_outcome(lambda: call(ref_jp2k),
                                   lambda: call(jp2k))
        assert out == ("ImportError", "no system libopenjp2 found")
