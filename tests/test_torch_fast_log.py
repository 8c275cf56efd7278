"""The fast LoG route (profile ``log_dtype: bfloat16``, the reference's
``fast=True``) of ``magellanmapper_torch`` against the JAX reference, on
the CPU.

The reference's fast route runs the LoG's band products at
``Precision.DEFAULT``, which on the JAX CPU is float32; the port's sets
TF32 for those products on a card only, so on the CPU it computes float32
too. Tolerances: filter outputs within 1e-5 absolute of the reference's
(the two round their sums in another order; measured ~1e-7), and equal
to the port's own float32 route bit for bit; blob rows equal
(``testing.rows_equal``: coordinates exact, radii within 1e-6 relative);
grid tables equal. The TF32 switch is checked on a CUDA device object,
which needs no card: it is on inside the fast products and off again
after them, also when they raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.cv import detector as ref_detector
from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.ops import filters as ref_filters
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_tpu.stats import mlearn as ref_mlearn
from magellanmapper_torch import device as dev_mod
from magellanmapper_torch import testing
from magellanmapper_torch.cv import detector
from magellanmapper_torch.cv import stack_detect as sd
from magellanmapper_torch.io import cli
from magellanmapper_torch.ops import filters
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.stats import mlearn

torch.set_num_threads(1)

FAST = filters.FAST_PRECISION
DEFAULT = jax.lax.Precision.DEFAULT
ATOL = 1e-5


def _vol(shape=(14, 20, 18), seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _nuclei(shape, seed=0):
    vol, _ = testing.make_nuclei_volume(shape, seed, spacing=12, jitter=2)
    return (vol / vol.max()).astype(np.float32)


def _profiles(names, **overrides):
    out = []
    for cls in (ROIProfile, RefProfile):
        prof = cls()
        prof.add_profiles(names)
        prof.update(overrides)
        out.append(prof)
    return out


@pytest.mark.parametrize("axis,mode", [(0, "reflect"), (1, "nearest"),
                                       (2, "mirror"), (-1, "wrap")])
def test_conv1d_precision_matches_reference(axis, mode):
    vol = _vol()
    kernel = filters.gaussian_kernel1d(1.5, 2)
    got = filters.conv1d(torch.from_numpy(vol), kernel, axis, mode,
                         precision=FAST)
    want = ref_filters.conv1d(jnp.asarray(vol), kernel, axis, mode,
                              precision=DEFAULT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.equal(got, filters.conv1d(torch.from_numpy(vol), kernel,
                                           axis, mode))


@pytest.mark.parametrize("sigma", [1.2, (1.0, 2.0, 1.5)])
def test_gaussian_laplace_precision_matches_reference(sigma):
    vol = _vol()
    got = filters.gaussian_laplace(torch.from_numpy(vol), sigma,
                                   precision=FAST)
    want = ref_filters.gaussian_laplace(jnp.asarray(vol), sigma,
                                        precision=DEFAULT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.equal(got, filters.gaussian_laplace(
        torch.from_numpy(vol), sigma))


@pytest.mark.parametrize("shape", [(12, 16, 20), (6, 8, 800)])
def test_log_pyramid_precision_matches_reference(shape):
    """The band route, and past 768 samples the per-sigma stack whose
    long axis takes taps (which ignore the precision in both)."""
    vol = _vol(shape)
    sigmas = (1.5, 2.0, 2.5)
    got = filters.log_pyramid(torch.from_numpy(vol), sigmas, precision=FAST)
    want = ref_filters.log_pyramid(jnp.asarray(vol), sigmas,
                                   precision=DEFAULT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.equal(got, filters.log_pyramid(torch.from_numpy(vol),
                                                sigmas))


def test_band_precision_scopes_tf32():
    """TF32 is on inside a fast block on a card only, off after it,
    raising or not, and each such block is counted in
    ``device.TF32_SCOPES`` (set to 0 with the launch counters)."""
    card = torch.device("cuda")
    dev_mod.reset_launches()
    assert not torch.backends.cuda.matmul.allow_tf32
    with filters.band_precision(FAST, card):
        assert torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert dev_mod.TF32_SCOPES["band_products"] == 1
    with pytest.raises(RuntimeError, match="inside"):
        with filters.band_precision(FAST, card):
            raise RuntimeError("inside the fast products")
    assert not torch.backends.cuda.matmul.allow_tf32
    # the CPU's products stay float32: nothing is switched
    with filters.band_precision(FAST, torch.device("cpu")):
        assert not torch.backends.cuda.matmul.allow_tf32
    for prec in (None, "highest"):
        with filters.band_precision(prec, card):
            assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError):
        with filters.band_precision("bf16", card):
            pass
    assert dev_mod.TF32_SCOPES["band_products"] == 2
    dev_mod.reset_launches()
    assert dev_mod.TF32_SCOPES["band_products"] == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the fast pyramid takes
    its card branch here."""

    @property
    def device(self):
        return torch.device("cuda")


def test_fast_call_that_raises_leaves_tf32_off(monkeypatch):
    """The fast pyramid on a (reported) card: its products run with TF32
    on, and when one raises, TF32 is off again after the call."""
    seen = []

    def boom(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        raise RuntimeError("product failed")

    monkeypatch.setattr(filters, "sigma_tensor", lambda s, d: torch.tensor(
        s, dtype=torch.float32))
    monkeypatch.setattr(filters, "_bands", lambda s, o, n, m, t, d: (
        torch.stack([torch.from_numpy(filters._band_matrix(
            np.asarray(filters.gaussian_kernel1d(x, o, truncate=t),
                       np.float64).tobytes(), 2 * int(t * x + 0.5) + 1, n,
            m, 0.0)) for x in s])))
    monkeypatch.setattr(torch, "einsum", boom)
    vol = torch.Tensor._make_subclass(_OnCard, torch.from_numpy(_vol()))
    assert vol.device.type == "cuda"
    with pytest.raises(RuntimeError, match="product failed"):
        filters.log_pyramid(vol, (1.5, 2.0), precision=FAST)
    assert seen == [True]
    assert not torch.backends.cuda.matmul.allow_tf32


def test_blob_log_fast_matches_reference():
    roi = _nuclei((24, 48, 48))
    sigmas = tuple(ref_detector.sigma_list(3, 4, 6))
    want, want_valid = ref_detector.blob_log(
        jnp.asarray(roi), sigmas, 0.1, 0.5, 1024, fast=True)
    got, got_valid, count = detector.blob_log(
        torch.from_numpy(roi), sigmas, 0.1, 0.5, 1024, fast=True)
    want = np.asarray(want)[np.asarray(want_valid)]
    got = got[got_valid].numpy()
    assert len(want) > 5 and count >= len(got)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-6, atol=0)


def test_blob_log_multi_fast_matches_reference():
    roi = _nuclei((16, 32, 32))
    sigmas = tuple(ref_detector.sigma_list(3, 4, 10))
    ths = (0.05, 0.1, 0.2)
    want_rows, want_valid = ref_detector.blob_log_multi(
        jnp.asarray(roi), sigmas, jnp.asarray(ths), 0.5, 512, fast=True)
    got_rows, got_valid = detector.blob_log_multi(
        torch.from_numpy(roi), sigmas, ths, 0.5, 512, fast=True)
    for k in range(len(ths)):
        want = np.asarray(want_rows[k])[np.asarray(want_valid[k])]
        got = got_rows[k][got_valid[k]].numpy()
        assert len(want) > 0
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kwargs", [{}, {"preprocess": True,
                                         "near_max": [0.8]}])
def test_detect_blobs_reads_log_dtype(kwargs):
    roi = _nuclei((24, 48, 48), seed=1)
    prof, ref_prof = _profiles("lightsheet", log_dtype="bfloat16",
                               isotropic=None)
    want = ref_detector.detect_blobs(roi, ref_prof, (1.0, 1.0, 1.0),
                                     **kwargs)
    got = detector.detect_blobs(roi, prof, (1.0, 1.0, 1.0), device="cpu",
                                **kwargs)
    assert want is not None and testing.rows_equal(got, want)


def test_detect_blobs_blocks_fast_slab_staging_matches_reference(
        monkeypatch):
    """The fast route through the slab-staged block path."""
    vol = testing.make_nuclei_volume((40, 160, 160), seed=2)[0]
    prof, ref_prof = _profiles("lightsheet", log_dtype="bfloat16")
    monkeypatch.setattr(sd, "_RESIDENT_BYTES_BUDGET", 1 << 20)
    want, _ = ref_sd.detect_blobs_blocks(vol, ref_prof, (1.0, 1.0, 1.0))
    got, _ = sd.detect_blobs_blocks(vol, prof, (1.0, 1.0, 1.0),
                                    device="cpu")
    assert want is not None and len(want) > 20
    assert testing.rows_equal(got, want)


def test_step_params_carry_the_fast_flag():
    for dtype, fast in (("bfloat16", True), ("BFloat16", True),
                        ("float32", False)):
        prof = _profiles("lightsheet", log_dtype=dtype)[0]
        blocks = sd.setup_blocks(prof, (30, 64, 64), (1.0, 1.0, 1.0))
        bs = np.minimum(blocks.max_pixels + blocks.overlap, (30, 64, 64))
        assert sd.step_params(prof, blocks, bs, (1.0, 1.0, 1.0),
                              1000.0).fast is fast
        assert detector.is_fast(prof) is fast


def test_grid_search_fast_matches_reference():
    vol, centres = testing.make_grid_roi((24, 48, 48), 0, spacing=12,
                                         jitter=2)
    prof, ref_prof = _profiles("4xnuc", log_dtype="bfloat16")
    thresholds = [0.04, 0.08, 0.12, 0.16]
    truth = np.zeros((len(centres), 10), np.float32)
    truth[:, :3] = centres
    truth[:, 3] = 3.0
    hyper = {"detection_threshold": thresholds}
    want = ref_mlearn.grid_search(
        hyper, None, truth, (3, 3, 3),
        ref_mlearn.make_fn_detect_multi(vol, (1.0, 1.0, 1.0), ref_prof))
    got = mlearn.grid_search(
        hyper, None, truth, (3, 3, 3),
        mlearn.make_fn_detect_multi(vol, (1.0, 1.0, 1.0), prof, "cpu"))
    pd.testing.assert_frame_equal(got, want)
    assert got["TP"].sum() > 0 and got["FP"].nunique() > 1


def _run_entry(entry, log_dtype, tmp_path):
    """Drive one user-facing entry point on a small volume with the
    profile's ``log_dtype``."""
    res = (1.0, 1.0, 1.0)
    if entry == "make_fn_detect_multi":
        vol, centres = testing.make_grid_roi((24, 48, 48), 0, spacing=12,
                                             jitter=2)
        prof = _profiles("4xnuc", log_dtype=log_dtype)[0]
        truth = np.zeros((len(centres), 10), np.float32)
        truth[:, :3] = centres
        truth[:, 3] = 3.0
        mlearn.grid_search(
            {"detection_threshold": [0.08, 0.16]}, None, truth, (3, 3, 3),
            mlearn.make_fn_detect_multi(vol, res, prof, "cpu"))
        return
    vol = _nuclei((24, 48, 48), seed=1)
    prof = _profiles("lightsheet", log_dtype=log_dtype, isotropic=None)[0]
    if entry == "detect_blobs":
        detector.detect_blobs(vol, prof, res, device="cpu")
    elif entry == "detect_blobs_blocks":
        sd.detect_blobs_blocks(vol, prof, res, device="cpu")
    else:
        img = tmp_path / f"{log_dtype}.npy"
        np.save(img, vol)
        yml = tmp_path / "log_dtype.yml"
        yml.write_text(f"log_dtype: {log_dtype}\n")
        cli.main(["--img", str(img), "--proc", "detect", "--roi_profile",
                  f"lightsheet,{yml}", "--device", "cpu"])


@pytest.mark.parametrize("entry", ["detect_blobs", "detect_blobs_blocks",
                                   "make_fn_detect_multi", "cli"])
def test_entry_points_hand_the_fast_precision_to_the_log(
        monkeypatch, tmp_path, entry):
    """With ``log_dtype: bfloat16`` each entry point runs the LoG's band
    products at the fast route's precision, and with float32 never:
    ``band_precision`` is the one switch, so a dropped ``fast=`` on any
    path between the entry point and the pyramid shows here."""
    seen = []
    real = filters.band_precision

    def spy(precision, device):
        seen.append(precision)
        return real(precision, device)

    monkeypatch.setattr(filters, "band_precision", spy)
    _run_entry(entry, "bfloat16", tmp_path)
    assert FAST in seen
    seen.clear()
    _run_entry(entry, "float32", tmp_path)
    assert seen and FAST not in seen
    assert not torch.backends.cuda.matmul.allow_tf32


def test_stack_times_copy():
    assert [(m.name, m.value) for m in sd.StackTimes] == [
        (m.name, m.value) for m in ref_sd.StackTimes]


@pytest.mark.cuda
def test_fast_route_uses_tf32_on_the_card():
    """On a card the fast pyramid differs from the float32 one (TF32
    products ran), by less than the smoke run's 1e-3 limit, and TF32 is
    off afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    vol = torch.from_numpy(_nuclei((32, 128, 128))).cuda()
    sigmas = (2.0, 2.5, 3.0)
    ref = filters.log_pyramid(vol, sigmas)
    fast = filters.log_pyramid(vol, sigmas, precision=FAST)
    err = float((fast - ref).abs().max())
    assert 0 < err < 1e-3
    assert not torch.backends.cuda.matmul.allow_tf32
