"""Stage checkpoints of ``magellanmapper_torch`` registration
(``utils.checkpoint`` and ``register_duo``/``register(checkpoint_dir=
...)``) against ``magellanmapper_tpu``'s, on a seeded (20, 28, 28)
gauntlet pair (every metric stride 1).

The port writes ``torch.save`` files where the reference writes Orbax
directories (a difference of format, not of results). Held exactly: a
saved stage reads back bit for bit; a registration stopped after a stage
and resumed equals the uninterrupted one (parameters, moved image,
labels); a rerun restores every stage and optimises none; as in the
reference, a restored stage records no ``dsc_stage_<kind>``; the fallback
metric's retry checkpoints under ``<dir>/fallback``. Against the
reference's own resumed run, the parameters within the tolerances of
``test_torch_reg_engine.py``.
"""

import os

import numpy as np
import pytest
import torch

from magellanmapper_tpu.atlas import gauntlet as ref_gauntlet
from magellanmapper_tpu.atlas import reg_engine as ref
from magellanmapper_tpu.settings import atlas_prof as ref_prof
from magellanmapper_tpu.utils import checkpoint as ref_checkpoint
from magellanmapper_torch.atlas import reg_engine, register
from magellanmapper_torch.settings import atlas_prof
from magellanmapper_torch.utils import checkpoint

torch.set_num_threads(1)

SHAPE = (20, 28, 28)
PARAM_ATOL = {"t": 1e-2, "W": 1e-3, "grid": 5e-2}


@pytest.fixture(scope="module")
def pair():
    return ref_gauntlet.build_pair(SHAPE, seed=0, ffd_spacing=16.0,
                                   ffd_ctrl_sigma=3.0)


def _profile(cls=atlas_prof.AtlasProfile, stages=("translation", "affine",
                                                   "bspline")):
    prof = cls()
    for kind, n in (("translation", 24), ("affine", 16), ("bspline", 8)):
        key = f"reg_{kind}"
        prof[key] = dict(prof[key], max_iter=n, num_resolutions=2) \
            if kind in stages else None
    if prof["reg_bspline"]:
        prof["reg_bspline"]["grid_space_voxels"] = 8
    return prof


class _Stop(Exception):
    pass


def test_save_load_roundtrip(tmp_path):
    tree = {"W": np.eye(3, dtype=np.float32) * 0.1,
            "t": torch.tensor([1.0, 2.0, 3.0]),
            "grid": np.random.default_rng(0).normal(
                size=(3, 4, 5, 6)).astype(np.float32)}
    path = checkpoint.save_pytree(str(tmp_path / "stage.pt"), tree)
    assert os.path.isabs(path) and os.path.isfile(path)
    back = checkpoint.load_pytree(path)
    assert sorted(back) == sorted(tree)
    for k, v in tree.items():
        assert back[k].device.type == "cpu"
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v))
    # a flat dict of tensors, readable without unpickling code
    assert sorted(torch.load(path, weights_only=True)) == sorted(tree)
    checkpoint.save_pytree(path, {"t": np.zeros(3, np.float32)})
    assert sorted(checkpoint.load_pytree(path)) == ["t"]


def test_missing_returns_none(tmp_path):
    assert checkpoint.load_pytree(str(tmp_path / "nope.pt")) is None
    assert ref_checkpoint.load_pytree(str(tmp_path / "nope")) is None
    ckpt = checkpoint.RegistrationCheckpoint(str(tmp_path / "ck"))
    assert os.path.isdir(ckpt.dir) and ckpt.load_stage("affine") is None


@pytest.mark.parametrize("stop_before", ["affine", "bspline"])
def test_resumed_registration_equals_uninterrupted(pair, tmp_path,
                                                   monkeypatch, stop_before):
    prof = _profile()
    moved, res = reg_engine.register_duo(
        pair["fixed"], pair["moving"], prof,
        checkpoint_dir=str(tmp_path / "whole"), device="cpu")
    assert sorted(os.listdir(tmp_path / "whole")) == [
        "affine.pt", "bspline.pt", "translation.pt"]

    # stopped as a killed process would be, before ``stop_before`` ran
    orig = reg_engine.register_stage

    def stop(*args, **kwargs):
        if kwargs.get("kind") == stop_before:
            raise _Stop
        return orig(*args, **kwargs)

    ckdir = str(tmp_path / "stopped")
    monkeypatch.setattr(reg_engine, "register_stage", stop)
    with pytest.raises(_Stop):
        reg_engine.register_duo(pair["fixed"], pair["moving"], prof,
                                checkpoint_dir=ckdir, device="cpu")
    monkeypatch.setattr(reg_engine, "register_stage", orig)
    saved = sorted(os.listdir(ckdir))
    assert saved == (["translation.pt"] if stop_before == "affine"
                     else ["affine.pt", "translation.pt"])

    moved2, res2 = reg_engine.register_duo(
        pair["fixed"], pair["moving"], prof, checkpoint_dir=ckdir,
        device="cpu")
    assert [k for k, _ in res2.stages] == [k for k, _ in res.stages]
    for (_, a), (_, b) in zip(res.stages, res2.stages):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(moved, moved2)
    assert res2.bspline_spacing == res.bspline_spacing
    np.testing.assert_array_equal(
        res.transform_img(pair["labels"], order=0),
        res2.transform_img(pair["labels"], order=0))


def test_rerun_restores_every_stage(pair, tmp_path, monkeypatch):
    prof = _profile()
    ckdir = str(tmp_path / "ck")
    moved, res = reg_engine.register_duo(
        pair["fixed"], pair["moving"], prof, checkpoint_dir=ckdir,
        device="cpu")
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs.get("kind"))
        raise AssertionError("a saved stage was optimised again")

    monkeypatch.setattr(reg_engine, "register_stage", spy)
    moved2, res2 = reg_engine.register_duo(
        pair["fixed"], pair["moving"], prof, checkpoint_dir=ckdir,
        record_stage_dsc=True, device="cpu")
    assert calls == [] and res2.levels == []
    np.testing.assert_array_equal(moved, moved2)
    assert sorted(res2.metrics) == ["dsc_fixed_moved"]


def test_resume_matches_reference(pair, tmp_path):
    """Both engines: a translation-only run saves its stage; the full
    profile then restores it, optimises the rest and records stage DSCs
    for the optimised stages only."""
    got = {}
    for name, engine, cls, kw in (
            ("port", reg_engine, atlas_prof.AtlasProfile,
             {"device": "cpu"}),
            ("ref", ref, ref_prof.AtlasProfile, {})):
        ckdir = str(tmp_path / name)
        engine.register_duo(pair["fixed"], pair["moving"],
                            _profile(cls, ("translation",)),
                            checkpoint_dir=ckdir, **kw)
        _, res = engine.register_duo(
            pair["fixed"], pair["moving"], _profile(cls),
            checkpoint_dir=ckdir, record_stage_dsc=True, **kw)
        got[name] = res
    port, want = got["port"], got["ref"]
    assert sorted(port.metrics) == sorted(want.metrics) == [
        "dsc_fixed_moved", "dsc_stage_affine", "dsc_stage_bspline"]
    assert port.bspline_spacing == want.bspline_spacing
    for (kind, a), (_, b) in zip(port.stages_numpy(), want.stages):
        for k in b:
            np.testing.assert_allclose(
                a[k], np.asarray(b[k]), rtol=0,
                atol=1e-3 if kind == "translation" else PARAM_ATOL[k])


def test_fallback_retry_checkpoints_under_fallback(pair, tmp_path,
                                                   monkeypatch):
    prof = _profile(stages=("translation", "affine"))
    prof["metric_sim_fallback"] = (1.01, "AdvancedNormalizedCorrelation")
    imgs = {"atlas": pair["moving"], "labels": pair["labels"]}
    ckdir = str(tmp_path / "ck")
    out = register.register(pair["fixed"], imgs, prof, write_imgs=False,
                            checkpoint_dir=ckdir, device="cpu")
    assert sorted(os.listdir(ckdir)) == [
        "affine.pt", "fallback", "translation.pt"]
    assert sorted(os.listdir(os.path.join(ckdir, "fallback"))) == [
        "affine.pt", "translation.pt"]
    monkeypatch.setattr(reg_engine, "register_stage", None)
    again = register.register(pair["fixed"], imgs, prof, write_imgs=False,
                              checkpoint_dir=ckdir, device="cpu")
    np.testing.assert_array_equal(out["moved_labels"],
                                  again["moved_labels"])
    np.testing.assert_array_equal(out["moved_atlas"], again["moved_atlas"])
