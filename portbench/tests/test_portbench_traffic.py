"""The traffic generators: deterministic by seed, and the frozen NumPy
fixture's volume for the same draws."""

import numpy as np
import torch

from portbench.traffic import frozen_numpy, grid_roi, nuclei, nuclei_volume

PARAMS = {"shape": [36, 64, 84], "spacing": 20, "jitter": 4, "sigma": 2.7,
          "amp": [1500, 3000], "noise": [200, 30]}


def test_same_seed_same_volume_and_other_seed_other():
    a = nuclei_volume.make(PARAMS, 2 ** 33 + 5, "cpu")
    b = nuclei_volume.make(PARAMS, 2 ** 33 + 5, "cpu")
    c = nuclei_volume.make(PARAMS, 2 ** 33 + 6, "cpu")
    assert a["volume"].dtype == np.uint16
    assert np.array_equal(a["volume"], b["volume"])
    assert np.array_equal(a["centres"], b["centres"])
    assert not np.array_equal(a["volume"], c["volume"])


def test_matches_the_frozen_numpy_fixture_draw_for_draw():
    shape = tuple(PARAMS["shape"])
    seed = 11
    made = nuclei_volume.make(PARAMS, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    centres, amps, _ = nuclei.draw(shape, 20, 4, (1500, 3000), gen, "cpu")
    noise = torch.randn(shape, generator=gen) * 30.0 + 200.0
    want = frozen_numpy.render(shape, centres.numpy(), amps.numpy(),
                               noise.numpy())
    diff = np.abs(made["volume"].astype(int) - want.astype(int))
    # the stamps' sums differ in order only: a truncation may move by 1
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3
    assert np.array_equal(made["centres"], centres.numpy())


def test_every_seed_draws_the_same_sizes_in_another_order():
    shape = tuple(PARAMS["shape"])
    a, b = (nuclei.draw(shape, 20, 4, (1500, 3000),
                        torch.Generator().manual_seed(s), "cpu")
            for s in (1, 2))
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
    assert torch.equal(torch.sort(a[1]).values, torch.sort(b[1]).values)
    base = torch.from_numpy(np.stack(np.meshgrid(
        *nuclei.grid(shape, 20), indexing="ij"), -1).reshape(-1, 3))
    for ax in range(3):
        ja, jb = a[0][:, ax] - base[:, ax], b[0][:, ax] - base[:, ax]
        assert torch.equal(torch.sort(ja).values, torch.sort(jb).values)


def test_grid_and_jitter_as_the_frozen_fixture():
    shape = tuple(PARAMS["shape"])
    _, frozen = frozen_numpy.make_nuclei_volume(shape, 3)
    made = nuclei_volume.make(PARAMS, 3, "cpu")
    assert len(made["centres"]) == len(frozen) == nuclei.num_nuclei(
        shape, 20)
    base = np.stack(np.meshgrid(*nuclei.grid(shape, 20), indexing="ij"),
                    -1).reshape(-1, 3)
    assert np.abs(made["centres"] - base).max() <= 4


def test_counts_of_the_cells_traffic():
    assert nuclei.num_nuclei((640, 1024, 1024), 20) == 83232
    assert nuclei.num_nuclei((64, 512, 512), 20) == 1875


def test_grid_roi_is_the_frozen_roi_for_its_volumes():
    params = dict(PARAMS, shape=[24, 64, 64], decoy=0.3)
    made = grid_roi.make(params, 5, "cpu")
    a = nuclei_volume.make(params, 5, "cpu")["volume"]
    b = nuclei_volume.make(params, 6, "cpu")["volume"]
    assert made["volume"].dtype == np.float32
    np.testing.assert_array_equal(made["volume"],
                                  frozen_numpy.grid_roi_of(a, b, 20, 0.3))
    roi, centres = frozen_numpy.make_grid_roi((24, 64, 64), 5)
    assert roi.max() == 1.0 and len(centres) == len(made["centres"])
