"""The port's ``parallel/`` against the reference's sharded detection.

One world of four CPU ranks over gloo (``parallel.launch.spawn``) runs
every case of this module once (the ``world`` fixture); the reference runs
in this process on its virtual CPU devices, on the same seeded inputs.
Meshes of 1 and 2 ranks are sub-meshes of that world. The reference's
tests (``tests/test_parallel.py``) run on 8 devices where this world has
4, so the (dp, sp, spy) = (2, 2, 2) cases become (2, 2, 1) and (1, 2, 2).

Tolerances: blob rows equal after sorting (``testing.rows_equal``:
coordinates exact, radii within 1e-6 relative); mesh shapes and halo
planes exact.
"""

import multiprocessing

import numpy as np
import pytest
import torch
import torch.distributed as dist

from magellanmapper_tpu.cv import blobs as ref_blobs_mod
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.io import np_io as ref_np_io
from magellanmapper_tpu.parallel import distributed as ref_distributed
from magellanmapper_tpu.parallel import halo as ref_halo
from magellanmapper_tpu.parallel import mesh as ref_mesh
from magellanmapper_tpu.settings.roi_prof import ROIProfile as RefProfile
from magellanmapper_torch.cv import stack_detect
from magellanmapper_torch.parallel import launch, mesh as mesh_mod
from magellanmapper_torch.settings.roi_prof import ROIProfile
from magellanmapper_torch.testing import rows_equal

torch.set_num_threads(1)

RES = (1.0, 1.0, 1.0)
HALO = "magellanmapper_torch.parallel.halo:"
CASES = "magellanmapper_torch.parallel.cases:"
BLOCKS = ("magellanmapper_torch.parallel.distributed:"
          "detect_blobs_blocks_sharded")


def _nuclei(seed, shape, n):
    """The reference test's Gaussian nuclei (``tests/test_parallel.py``)."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    centers = np.column_stack([rng.uniform(6, s - 6, size=n) for s in shape])
    for cz, cy, cx in centers:
        sig = 4.0 / np.sqrt(3)
        vol += np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2)
                      / (2 * sig ** 2))
    return np.clip(vol / vol.max(), 0, None)


def _profiles(**settings):
    """The same settings as a port profile and a reference profile."""
    port, ref = ROIProfile(), RefProfile()
    for prof in (port, ref):
        prof.update(settings)
    return port, ref


PROF_A = dict(min_sigma_factor=2.0, max_sigma_factor=4.0, num_sigma=5,
              max_blobs_per_block=512)
PROF_SPY = dict(min_sigma_factor=1.5, max_sigma_factor=3.0, num_sigma=4,
                max_blobs_per_block=512)
PROF_PRE = dict(PROF_SPY, denoise_size=16)
PROF_BLOCKS = dict(PROF_A, segment_size=30, denoise_size=None)
#: every block's peaks fill this capacity: each is re-detected at 8, then 16
PROF_BLOCKS_OVERFLOW = dict(PROF_BLOCKS, max_blobs_per_block=4)
PROF_CH = dict(min_sigma_factor=2.0, max_sigma_factor=4.0, num_sigma=4,
               max_blobs_per_block=256)
PROF_TAIL = dict(min_sigma_factor=2.0, max_sigma_factor=3.5, num_sigma=3,
                 max_blobs_per_block=128)
PROF_NEAR = dict(PROF_CH, denoise_size=16)
#: a shard holds more peaks than this capacity (the capacity pin)
PROF_CAP = dict(PROF_A, max_blobs_per_block=8)


@pytest.fixture(scope="module")
def data():
    vol_a = _nuclei(41, (32, 40, 40), 12)
    vol_b = _nuclei(43, (32, 40, 40), 12)
    return {
        "a": _nuclei(3, (64, 48, 48), 30),
        "spy": _nuclei(7, (40, 44, 44), 25),
        "pre": _nuclei(11, (48, 32, 32), 20),
        "blocks": _nuclei(21, (40, 60, 60), 30),
        "stack": np.stack([_nuclei(31, (32, 40, 40), 12)] * 2, axis=-1),
        "ab": np.stack([vol_a, vol_b], axis=-1),
        "a_only": vol_a, "b_only": vol_b,
        "tail": _nuclei(47, (24, 32, 32), 8),
        "near": _nuclei(53, (32, 32, 32), 10),
        "planes": np.arange(16 * 4 * 4, dtype=np.float32).reshape(16, 4, 4),
    }


def _cases(d):
    port = {k: _profiles(**v)[0] for k, v in (
        ("a", PROF_A), ("spy", PROF_SPY), ("pre", PROF_PRE),
        ("blocks", PROF_BLOCKS), ("overflow", PROF_BLOCKS_OVERFLOW),
        ("ch", PROF_CH), ("tail", PROF_TAIL),
        ("near", PROF_NEAR), ("cap", PROF_CAP))}
    cpu = {"device": "cpu"}
    near_pre = float(np.percentile(d["pre"][::3], 99.5))
    cases = [
        dict(key="shape_default", fn="magellanmapper_torch.parallel.mesh:shape",
             mesh=dict(n_devices=4)),
        dict(key="shape_dp", fn="magellanmapper_torch.parallel.mesh:shape",
             mesh=dict(n_devices=4, dp=2)),
        dict(key="shape_spy", fn="magellanmapper_torch.parallel.mesh:shape",
             mesh=dict(n_devices=4, dp=1, spy=2)),
        dict(key="planes", fn=CASES + "halo_planes",
             args=(d["planes"], 2), kwargs=cpu, mesh=dict(n_devices=4, dp=1)),
        dict(key="spy", fn=HALO + "detect_blobs_sharded",
             args=(d["spy"], port["spy"], RES), kwargs=cpu,
             mesh=dict(n_devices=4, dp=1, sp=2, spy=2)),
        dict(key="pre", fn=HALO + "detect_blobs_sharded",
             args=(d["pre"], port["pre"], RES),
             kwargs=dict(cpu, preprocess=True, near_max=near_pre),
             mesh=dict(n_devices=4, dp=1)),
        dict(key="stack", fn=HALO + "detect_blobs_sharded_stack",
             args=(d["stack"], port["ch"], RES), kwargs=cpu,
             mesh=dict(n_devices=4, dp=1)),
        dict(key="dp_batched", fn=HALO + "detect_blobs_sharded_stack",
             args=(d["ab"], port["ch"], RES), kwargs=cpu,
             mesh=dict(n_devices=4, dp=2, sp=2)),
        dict(key="tail", fn=HALO + "detect_blobs_sharded_batch",
             args=([d["tail"]], port["tail"], RES), kwargs=cpu,
             mesh=dict(n_devices=4, dp=2, sp=2)),
        dict(key="near", fn=HALO + "detect_blobs_sharded_batch",
             args=([d["near"], d["near"] * 0.01], port["near"], RES),
             kwargs=dict(cpu, preprocess=True),
             mesh=dict(n_devices=4, dp=2, sp=2)),
        dict(key="cap", fn=HALO + "detect_blobs_sharded",
             args=(d["a"], port["cap"], RES), kwargs=cpu,
             mesh=dict(n_devices=4, dp=1)),
        dict(key="blocks_overflow", fn=BLOCKS,
             args=(d["blocks"], port["overflow"], RES), kwargs=cpu,
             mesh=dict(n_devices=4, dp=4, sp=1)),
    ]
    for n in (4, 2, 1):
        cases += [
            dict(key=f"a{n}", fn=HALO + "detect_blobs_sharded",
                 args=(d["a"], port["a"], RES), kwargs=cpu,
                 mesh=dict(n_devices=n, dp=1)),
            dict(key=f"blocks{n}", fn=BLOCKS,
                 args=(d["blocks"], port["blocks"], RES), kwargs=cpu,
                 mesh=dict(n_devices=n, dp=n, sp=1)),
        ]
    for key, vol in (("a_only", d["a_only"]), ("b_only", d["b_only"])):
        cases.append(dict(key=key, fn=HALO + "detect_blobs_sharded",
                          args=(vol, port["ch"], RES), kwargs=cpu,
                          mesh=dict(n_devices=2, dp=1, sp=2)))
    return cases


@pytest.fixture(scope="module")
def world(data):
    """Every rank's ``{key: result}`` of this module's cases."""
    return launch.spawn(launch.run_cases, 4, device="cpu", timeout_s=300,
                        args=(_cases(data),))


def _ref(vol, settings, mesh, **kw):
    return ref_halo.detect_blobs_sharded(
        vol, _profiles(**settings)[1], RES, mesh=mesh, **kw)


class TestMesh:
    def test_make_mesh_default(self, world):
        assert world[0]["shape_default"] == {"dp": 1, "sp": 4, "spy": 1}
        ref = ref_mesh.make_mesh(4)
        assert ref.shape["dp"] == 1 and ref.shape["sp"] == 4

    def test_make_mesh_dp(self, world):
        assert world[0]["shape_dp"] == dict(ref_mesh.make_mesh(4, dp=2).shape)

    def test_make_mesh_spy(self, world):
        assert world[0]["shape_spy"] == dict(
            ref_mesh.make_mesh(4, dp=1, spy=2).shape)

    def test_bad_factorization(self):
        for make in (ref_mesh.make_mesh, mesh_mod.make_mesh):
            with pytest.raises(ValueError, match="must equal device count"):
                make(8, dp=3, sp=3)

    def test_mesh_without_a_process_group_names_the_launchers(self):
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="torchrun"):
            mesh_mod.make_mesh(2)


class TestShardedDetection:
    def test_matches_single_device(self, world, data):
        """sp=4 equals the reference's sp=4 run, row for row, and the
        port's single-device detector up to the reference test's 1%."""
        got = world[0]["a4"]
        want = _ref(data["a"], PROF_A, ref_mesh.make_mesh(4, dp=1))
        assert got is not None and rows_equal(got, want)
        from magellanmapper_torch.cv import detector
        single = detector.detect_blobs(
            data["a"], _profiles(**PROF_A)[0], RES, device="cpu")
        assert rows_equal(got, single)

    def test_matches_single_device_spy(self, world, data):
        """(sp, spy) = (2, 2): z and y halos."""
        want = _ref(data["spy"], PROF_SPY,
                    ref_mesh.make_mesh(4, dp=1, sp=2, spy=2))
        assert rows_equal(world[0]["spy"], want)

    def test_preproc_parity(self, world, data):
        """In-step saturate/denoise (K4's plain version here) as the
        reference's in-step preprocessing."""
        near = float(np.percentile(data["pre"][::3], 99.5))
        want = _ref(data["pre"], PROF_PRE, ref_mesh.make_mesh(4, dp=1),
                    preprocess=True, near_max=near)
        assert world[0]["pre"] is not None
        assert rows_equal(world[0]["pre"], want)

    def test_halo_exchange_planes(self, world, data):
        """Halo planes carry the neighbour's planes; the boundary shards
        reflect their own (scipy 'reflect': d c b a | a b c d)."""
        vol = data["planes"]
        out = [world[r]["planes"] for r in range(4)]
        shard_z = 4
        np.testing.assert_array_equal(out[1][:2], vol[shard_z - 2:shard_z])
        np.testing.assert_array_equal(out[0][:2], vol[1::-1])
        np.testing.assert_array_equal(
            out[2][-2:], vol[3 * shard_z:3 * shard_z + 2])
        np.testing.assert_array_equal(out[3][-2:], vol[-1:-3:-1])
        for r in range(4):
            np.testing.assert_array_equal(
                out[r][2:-2], vol[r * shard_z:(r + 1) * shard_z])

    def test_shard_over_capacity_keeps_the_top_peaks(self, world, data):
        """Capacity pin: each shard keeps its ``max_blobs_per_block``
        strongest peaks (halo peaks included) before pruning, as the
        reference does, so a shard holding more peaks than that loses
        blobs the whole-volume run keeps; both packages lose the same."""
        want = _ref(data["a"], PROF_CAP, ref_mesh.make_mesh(4, dp=1))
        got = world[0]["cap"]
        assert rows_equal(got, want)
        assert len(got) < len(world[0]["a4"])


class TestDistributedBlocks:
    def test_sharded_blocks_match_single(self, world, data):
        """Blocks dealt over 4 ranks equal the port's single-device
        whole-stack result and the reference's blocks over 8 devices."""
        port, ref = _profiles(**PROF_BLOCKS)
        single, _ = stack_detect.detect_blobs_blocks(
            data["blocks"], port, RES, preprocess=False, device="cpu")
        got = world[0]["blocks4"][0]
        assert rows_equal(got, single)
        want, _ = ref_distributed.detect_blobs_blocks_sharded(
            data["blocks"], ref, RES, mesh=ref_mesh.make_mesh(8, dp=8, sp=1))
        assert rows_equal(got, want)

    def test_sharded_overflow_retry_matches_single(
            self, world, data, caplog):
        """At a capacity every block's peaks fill, each rank re-detects
        its blocks at doubled capacities and the result equals the
        single-device run's, itself equal to the full-capacity run."""
        port, _ = _profiles(**PROF_BLOCKS_OVERFLOW)
        with caplog.at_level("INFO", logger=stack_detect.__name__):
            single, _ = stack_detect.detect_blobs_blocks(
                data["blocks"], port, RES, preprocess=False, device="cpu")
        assert "re-detecting 8 dense blocks at capacity 8" in caplog.text
        full, _ = stack_detect.detect_blobs_blocks(
            data["blocks"], _profiles(**PROF_BLOCKS)[0], RES,
            preprocess=False, device="cpu")
        got = world[0]["blocks_overflow"][0]
        assert rows_equal(got, single)
        assert rows_equal(got, full)


class TestShardedMultichannel:
    def test_channels_stamped(self, world, data):
        blobs = world[0]["stack"]
        assert set(np.unique(blobs[:, 6]).tolist()) == {0.0, 1.0}
        want = ref_halo.detect_blobs_sharded_stack(
            data["stack"], _profiles(**PROF_CH)[1], RES,
            mesh=ref_mesh.make_mesh(4, dp=1))
        assert rows_equal(blobs, want)


class TestShardedDpBatch:
    def test_channels_batch_over_dp(self, world, data):
        """Channels sharing a profile ride dp in one step and equal
        per-channel runs at dp=1 (the reference's dp=2, sp=4 run too)."""
        batched = world[0]["dp_batched"]
        singles = []
        for chl, key in ((0, "a_only"), (1, "b_only")):
            b = world[0][key].copy()
            ref_blobs_mod.Blobs.set_blob_channel(b, chl)
            singles.append(b)
        assert rows_equal(batched, np.vstack(singles))
        want = ref_halo.detect_blobs_sharded_stack(
            data["ab"], _profiles(**PROF_CH)[1], RES,
            mesh=ref_mesh.make_mesh(8, dp=2, sp=4))
        assert rows_equal(batched, want)

    def test_dp_tail_fill_dropped(self, world, data):
        res = world[0]["tail"]
        assert len(res) == 1 and res[0] is not None
        want = ref_halo.detect_blobs_sharded_batch(
            [data["tail"]], _profiles(**PROF_TAIL)[1], RES,
            mesh=ref_mesh.make_mesh(8, dp=2, sp=4))
        assert rows_equal(res[0], want[0])

    def test_per_channel_near_max(self, world, data):
        """A dim channel (0.01x) saturates with its own near-max and
        detects the same blobs as the bright one."""
        res = world[0]["near"]
        assert res[0] is not None and res[1] is not None
        a = set(map(tuple, np.round(res[0][:, :3], 2)))
        b = set(map(tuple, np.round(res[1][:, :3], 2)))
        assert len(a & b) >= 0.95 * max(len(a), len(b))
        want = ref_halo.detect_blobs_sharded_batch(
            [data["near"], data["near"] * 0.01], _profiles(**PROF_NEAR)[1],
            RES, mesh=ref_mesh.make_mesh(8, dp=2, sp=4), preprocess=True)
        for got, ref in zip(res, want):
            assert rows_equal(got, ref)


@pytest.mark.parametrize("name", ["a", "blocks"])
@pytest.mark.parametrize("n", [2, 4])
def test_world_sizes_agree(world, name, n):
    """A sharded call gives the rows of a world of one at 2 and 4 ranks,
    and every rank returns the same rows."""
    def rows(rank, key):
        out = world[rank][key]
        return out[0] if name == "blocks" else out  # (blobs, timing)

    got = rows(0, f"{name}{n}")
    assert rows_equal(got, rows(0, f"{name}1"))
    for r in range(1, n):
        np.testing.assert_array_equal(rows(r, f"{name}{n}"), got)


def test_ranks_outside_a_sub_mesh_skip_its_cases(world):
    """Ranks 2 and 3 are outside the two-rank sub-mesh and run none of its
    cases."""
    assert "a2" in world[1] and "a2" not in world[2]
    assert "a1" not in world[1]


def test_a_failing_rank_fails_the_caller():
    bad = [dict(key="x", fn="magellanmapper_torch.parallel.mesh:make_mesh",
                kwargs=dict(n_devices=4, dp=3, sp=3))]
    with pytest.raises(Exception, match="must equal device count"):
        launch.spawn(launch.run_cases, 2, device="cpu", timeout_s=120,
                     args=(bad,))


def test_a_world_past_its_time_limit_is_killed():
    with pytest.raises(TimeoutError, match="did not finish"):
        launch.spawn(launch.run_cases, 2, device="cpu", timeout_s=0.5,
                     args=([],))
    assert not multiprocessing.active_children()


def test_cli_mesh_writes_the_reference_cli_blobs(tmp_path, data):
    """``--proc detect --mesh 1,2`` in a world of two writes the blob
    archive of the reference's CLI with ``--mesh 1,2``."""
    vol = data["a"]
    ref_path = str(tmp_path / "ref.npy")
    port_path = str(tmp_path / "port.npy")
    for path in (ref_path, port_path):
        ref_np_io.write_npy(path, vol, resolutions=[list(RES)])
    argv = ["--proc", "detect", "--roi_profile", "lightsheet", "--mesh",
            "1,2"]
    ref_cli.main(["--img", ref_path] + argv)
    cases = [dict(key="cli", fn="magellanmapper_torch.io.cli:main",
                  args=(["--img", port_path, "--device", "cpu"] + argv,))]
    launch.spawn(launch.run_cases, 2, device="cpu", timeout_s=300,
                 args=(cases,))
    want = np.load(str(tmp_path / "ref_blobs.npz"))
    got = np.load(str(tmp_path / "port_blobs.npz"))
    assert len(want["segments"]) > 0
    assert rows_equal(got["segments"], want["segments"])
    np.testing.assert_array_equal(got["resolutions"], want["resolutions"])
