"""The blob classifier of the port (``magellanmapper_torch.cv.classifier``)
against the JAX package's Flax CNN: the forward pass with carried weights,
the first training step's loss and gradients, a training run's accuracy,
model files moving both ways, patches, whole-image classification on
channel 0, the classifier step of ``detect_blobs_stack``, checkpoints, and
``--proc classify`` through both command lines, on the CPU."""

import jax
import numpy as np
import optax
import pytest
import torch

from magellanmapper_tpu.cv import classifier as ref_clf
from magellanmapper_tpu.cv import stack_detect as ref_sd
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_torch import testing
from magellanmapper_torch.cv import classifier, stack_detect
from magellanmapper_torch.io import cli, np_io
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.utils import checkpoint

torch.set_num_threads(1)

#: forward pass with carried weights, on the probabilities
PROB_ATOL = 1e-6
#: first training step, loss and each gradient relative to its largest
GRAD_RTOL = 1e-5


def make_patch_data(n=200, seed=0):
    """Bright-centre patches are true blobs, flat noise false (the
    reference test's fixture)."""
    rng = np.random.default_rng(seed)
    size = classifier.PATCH_SIZE
    yy, xx = np.indices((size, size)).astype(np.float32)
    blob = np.exp(-((yy - size / 2) ** 2 + (xx - size / 2) ** 2) / 8.0)
    pos = blob[None] + rng.normal(0, 0.1, (n // 2, size, size))
    neg = rng.normal(0.3, 0.15, (n // 2, size, size))
    x = np.concatenate([pos, neg]).astype(np.float32)
    y = np.concatenate([np.ones(n // 2), np.zeros(n // 2)])
    order = rng.permutation(n)
    return x[order], y[order]


def _asymmetric(seed=0, n=64):
    """Reference weights and patches that a wrong flatten order, a
    transposed kernel or a flipped patch would change: off-centre ramps
    over noise."""
    rng = np.random.default_rng(seed)
    size = classifier.PATCH_SIZE
    yy, xx = np.indices((size, size)).astype(np.float32)
    x = (rng.random((n, size, size)) * 0.3
         + (yy * 2 + xx)[None] / (3 * size)
         * rng.random((n, 1, 1))).astype(np.float32)
    return ref_clf.BlobClassifier(seed=seed), x


def test_forward_with_carried_weights_matches_reference():
    ref, x = _asymmetric()
    port = classifier.BlobClassifier(params=ref.params, device="cpu")
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=0,
                               atol=PROB_ATOL)
    logits = np.asarray(ref.model.apply(ref.params, x))
    with torch.no_grad():
        got = port.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, logits, rtol=0, atol=PROB_ATOL)

    # the (C, H, W) flatten of PyTorch's default would miss the reference
    class ChwFlatten(classifier.PatchCNN):
        def forward(self, t):
            t = torch.nn.functional.max_pool2d(
                torch.relu(self.conv0(t[:, None])), 2)
            t = torch.nn.functional.max_pool2d(torch.relu(self.conv1(t)), 2)
            t = torch.relu(self.dense0(t.flatten(1)))
            return self.dense1(t)[:, 0]

    wrong = ChwFlatten()
    wrong.load_state_dict(classifier.params_from_reference(ref.params))
    with torch.no_grad():
        assert np.abs(wrong(torch.from_numpy(x)).numpy() - logits).max() \
            > 100 * PROB_ATOL


def test_params_round_trip_between_layouts():
    ref = ref_clf.BlobClassifier(seed=4)
    state = classifier.params_from_reference(ref.params)
    assert state["conv0.weight"].shape == (16, 1, 3, 3)
    assert state["dense0.weight"].shape == (64, 512)
    back = classifier.params_to_reference(state)
    for layer, leaves in ref.params["params"].items():
        for name, arr in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][name],
                                          np.asarray(arr))


def test_first_training_step_matches_reference():
    """The mean sigmoid cross-entropy and its gradients on one batch."""
    ref, x = _asymmetric(seed=2, n=128)
    y = (np.random.default_rng(3).random(128) > 0.5).astype(np.float32)

    def loss_fn(p):
        return optax.sigmoid_binary_cross_entropy(
            ref.model.apply(p, x), y).mean()

    loss, grads = jax.value_and_grad(loss_fn)(ref.params)
    want = classifier.params_from_reference(
        jax.tree_util.tree_map(np.asarray, grads))
    port = classifier.BlobClassifier(params=ref.params, device="cpu")
    got_loss = torch.nn.functional.binary_cross_entropy_with_logits(
        port.model(torch.from_numpy(x)), torch.from_numpy(y))
    got_loss.backward()
    got_loss = got_loss.detach()
    assert abs(float(got_loss) - float(loss)) <= GRAD_RTOL * abs(float(loss))
    for name, p in port.model.named_parameters():
        scale = float(want[name].abs().max())
        assert float((p.grad - want[name]).abs().max()) <= GRAD_RTOL * scale


def test_train_reaches_reference_accuracy():
    """20 epochs reach the reference test's accuracy."""
    x, y = make_patch_data()
    stats = classifier.BlobClassifier(device="cpu").train(x, y, epochs=20)
    assert stats["accuracy"] >= 0.9
    assert np.isfinite(stats["loss"])


def test_untrained_initialisation_follows_flax():
    """Flax's LeCun normal: truncated at two deviations of the underlying
    normal, variance 1/fan-in; zero biases; seeded, so two models of one
    seed are equal and another seed differs."""
    a = classifier.BlobClassifier(seed=0, device="cpu")
    b = classifier.BlobClassifier(seed=0, device="cpu")
    c = classifier.BlobClassifier(seed=1, device="cpu")
    ref = ref_clf.BlobClassifier(seed=0).params["params"]
    for (name, p), (_, q), (_, r) in zip(a.model.state_dict().items(),
                                         b.model.state_dict().items(),
                                         c.model.state_dict().items()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
            continue
        assert not torch.equal(p, r)
        fan_in = p[0].numel()
        bound = 2 / 0.87962566103423978 / np.sqrt(fan_in)
        assert float(p.abs().max()) <= bound
        layer = dict((v, k) for k, v in classifier.LAYERS)[name[:-7]]
        want = np.asarray(ref[layer]["kernel"])
        if p.numel() >= 512:
            assert abs(float(p.std()) * np.sqrt(fan_in) - 1) < 0.1
            assert abs(float(p.std()) / want.std() - 1) < 0.1


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_model_files_move_between_packages(tmp_path, saver):
    path = str(tmp_path / "model.pkl")
    x, y = make_patch_data(64, seed=5)
    if saver == "port":
        clf = classifier.BlobClassifier(seed=3, device="cpu")
        clf.train(x, y, epochs=2)
        clf.save(path)
        want = clf.predict(x)
        got = ref_clf.BlobClassifier.load(path).predict(x)
    else:
        clf = ref_clf.BlobClassifier(seed=3)
        clf.train(x, y, epochs=2)
        clf.save(path)
        want = clf.predict(x)
        got = classifier.BlobClassifier.load(path, device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_classifier_checkpoint_round_trip(tmp_path):
    clf = classifier.BlobClassifier(seed=6, device="cpu")
    path = checkpoint.save_classifier_state(str(tmp_path / "clf.pt"), clf)
    back = checkpoint.load_classifier_state(path, device="cpu")
    x, _ = make_patch_data(16)
    np.testing.assert_array_equal(back.predict(x), clf.predict(x))
    np.testing.assert_array_equal(
        classifier.BlobClassifier.load(path, device="cpu").predict(x),
        clf.predict(x))
    assert checkpoint.load_classifier_state(str(tmp_path / "none.pt"),
                                            device="cpu") is None


def test_train_step_sharded_raises_by_name():
    """The data-parallel step (ROADMAP item 10, now ported), in a world
    of one: the reference's step on a one-device mesh, loss within 1e-5,
    and the weights moved."""
    x, y = make_patch_data(8)
    ref = ref_clf.BlobClassifier(seed=0)
    tree = jax.tree.map(np.asarray, ref.params)
    want = ref.train_step_sharded(
        jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("dp",)), x, y)
    port = classifier.BlobClassifier(params=tree, device="cpu")
    with testing.world_of_one("cpu") as mesh:
        got = port.train_step_sharded(mesh, x, y)
    assert got == pytest.approx(want, abs=1e-5)
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                         port.params, tree)
    assert max(jax.tree.leaves(moved)) > 0


def _blob_volume(seed=1):
    """The reference test's volume: blob stamps in its upper half, noise in
    its lower; blob sites, empty sites, and edge and off-plane blobs."""
    rng = np.random.default_rng(seed)
    size = classifier.PATCH_SIZE
    vol = rng.normal(0.3, 0.1, (8, 128, 128)).astype(np.float32)
    yy, xx = np.indices((size, size)).astype(np.float32)
    stamp = np.exp(-((yy - 8) ** 2 + (xx - 8) ** 2) / 8.0)
    pos = np.column_stack([rng.integers(0, 8, 60), rng.integers(10, 60, 60),
                           rng.integers(10, 118, 60)])
    for z, y, x in pos:
        vol[z, y - 8:y + 8, x - 8:x + 8] += stamp
    neg = np.column_stack([rng.integers(0, 8, 60), rng.integers(70, 118, 60),
                           rng.integers(10, 118, 60)])
    sites = np.vstack([pos, neg]).astype(float)
    blobs = np.zeros((len(sites) + 4, 10))
    blobs[:len(sites), :3] = sites
    blobs[len(sites):, :3] = [[0, 0, 0], [7.5, 127, 3], [2.5, 64.5, 127.6],
                              [-0.4, 130, -3]]
    blobs[:, 3] = 3
    blobs[:, 4:6] = -1
    blobs[:, 6] = np.arange(len(blobs)) % 2
    labels = np.concatenate([np.ones(60), np.zeros(60)])
    return vol, blobs, labels


def test_extract_patches_matches_reference():
    vol, blobs, _ = _blob_volume()
    np.testing.assert_array_equal(
        classifier.extract_patches(vol, blobs, device="cpu"),
        ref_clf.extract_patches(vol, blobs))
    flat = np.full((3, 20, 20), 7, np.uint16)
    np.testing.assert_array_equal(
        classifier.extract_patches(flat, blobs[:3] % 3, device="cpu"),
        ref_clf.extract_patches(flat, blobs[:3] % 3))


def _trained_pair(vol, blobs, labels):
    ref = ref_clf.BlobClassifier()
    ref.train(ref_clf.extract_patches(vol, blobs[:len(labels)]), labels,
              epochs=25)
    return ref, classifier.BlobClassifier(params=ref.params, device="cpu")


def test_classify_blobs_and_whole_image_match_reference():
    vol, blobs, labels = _blob_volume()
    ref, port = _trained_pair(vol, blobs, labels)
    for channel in (1, None):
        got = classifier.classify_blobs(port, vol, blobs, channel=channel)
        want = ref_clf.classify_blobs(ref, vol, blobs, channel=channel)
        np.testing.assert_array_equal(got, want)
    assert np.mean(got[:60, 4] == 1) > 0.9
    assert np.mean(got[60:120, 4] == 0) > 0.9
    for planes in (3, 100):
        np.testing.assert_array_equal(
            classifier.classify_whole_image(port, vol, blobs,
                                            chunk_planes=planes),
            ref_clf.classify_whole_image(ref, vol, blobs,
                                         chunk_planes=planes))
    y_pred, y_score = classifier.classify_patches(
        port, ref_clf.extract_patches(vol, blobs))
    want_pred, want_score = ref_clf.classify_patches(
        ref, ref_clf.extract_patches(vol, blobs))
    np.testing.assert_array_equal(y_pred, want_pred)
    np.testing.assert_allclose(y_score, want_score, rtol=0, atol=PROB_ATOL)


def test_classify_image_uses_channel_0_for_every_channel_pin():
    """The reference classifies the blobs of every channel on channel 0's
    image (``ClassifyImage``, ``detect_blobs_stack``); the port does too.
    Fixture: channel 1 holds the blob stamps, channel 0 the same noise,
    so channel-1 blobs classified on channel 0 come out false."""
    vol, blobs, labels = _blob_volume()
    ref, port = _trained_pair(vol, blobs, labels)
    noise = np.random.default_rng(9).normal(0.3, 0.1, vol.shape).astype(
        np.float32)
    two = np.stack([noise, vol], axis=-1)[None]
    got = classifier.ClassifyImage(port, two, blobs).classify_whole_image()
    want = ref_clf.ClassifyImage(ref, two, blobs).classify_whole_image()
    np.testing.assert_array_equal(got, want)
    on_chl0 = classifier.classify_whole_image(port, noise, blobs)
    np.testing.assert_array_equal(got, on_chl0)
    on_chl1 = classifier.classify_whole_image(port, vol, blobs)
    assert (got[:60, 4] == 1).sum() < (on_chl1[:60, 4] == 1).sum()


def test_setup_classification_roi_copy():
    vol, blobs, _ = _blob_volume()
    for rel in (False, True):
        got = classifier.setup_classification_roi(
            vol[None], (1, 20, 100), (5, 60, 40), blobs, 16, rel)
        want = ref_clf.setup_classification_roi(
            vol[None], (1, 20, 100), (5, 60, 40), blobs, 16, rel)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_detect_blobs_stack_classifier_step_matches_reference():
    """The classifier step of ``detect_blobs_stack`` on a two-channel
    volume: both channels' blobs classified on channel 0."""
    vol = testing.make_coloc_volume((32, 80, 80), 0)[0]
    ref = ref_clf.BlobClassifier(seed=1)
    port = classifier.BlobClassifier(params=ref.params, device="cpu")
    prof, ref_prof = ROIProfile(), RefProfile()
    prof.add_profiles("lightsheet")
    ref_prof.add_profiles("lightsheet")
    got, _ = stack_detect.detect_blobs_stack(
        vol, prof, (1.0, 1.0, 1.0), classifier_model=port, device="cpu")
    want, _ = ref_sd.detect_blobs_stack(
        vol, ref_prof, (1.0, 1.0, 1.0), classifier_model=ref)
    np.testing.assert_array_equal(got.blobs, want.blobs)
    assert set(np.unique(got.blobs[:, 6])) == {0, 1}
    assert set(np.unique(got.blobs[:, 4])) <= {0, 1}


def test_cli_classify_matches_reference(tmp_path):
    """``--proc classify --classifier`` with a model file of the reference
    on blobs detected by each package's CLI; the archive's flags are
    saved back."""
    vol, centres, co, own = testing.make_coloc_volume((32, 80, 80), 0)
    x, y = make_patch_data(200)
    ref = ref_clf.BlobClassifier(seed=2)
    ref.train(x, y, epochs=3)
    model = str(tmp_path / "model.pkl")
    ref.save(model)
    paths = []
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        paths.append(str(tmp_path / name / "vol.npy"))
        np_io.write_npy(paths[-1], vol[None])
    detect = ["--proc", "detect", "--roi_profile", "lightsheet"]
    cli.main(["--img", paths[0]] + detect + ["--device", "cpu"])
    ref_cli.main(["--img", paths[1]] + detect)
    got = cli.main(["--img", paths[0], "--proc", "classify", "--classifier",
                    model, "--device", "cpu"])
    want = ref_cli.main(["--img", paths[1], "--proc", "classify",
                         "--classifier", model])
    np.testing.assert_array_equal(got.blobs, want.blobs)
    assert set(np.unique(got.blobs[:, 4])) <= {0, 1}
    with np.load(paths[0].replace(".npy", "_blobs.npz")) as arc:
        np.testing.assert_array_equal(arc["segments"], got.blobs)
    # without a model: an untrained classifier of seed 0 (its weights are
    # the port's own draw, so only its flags' form is compared)
    untrained = cli.main(["--img", paths[0], "--proc", "classify",
                          "--device", "cpu"])
    assert set(np.unique(untrained.blobs[:, 4])) <= {0, 1}
    np.testing.assert_array_equal(untrained.blobs[:, :4], got.blobs[:, :4])
