"""Operation and byte counts, roofline shares, and the trace's union of
device activity and its idle gaps."""

import pytest

from portbench import counts, roofline, trace

H100 = "NVIDIA H100 80GB HBM3"


def test_counts_reproduce_the_kernel_tables_figures():
    # K1 on a (10, 156, 128, 128) cube with 372 peaks: 102 MB
    k1 = counts.peak_candidates((10, 156, 128, 128), 372)
    assert round(k1[0] / 1e6) == 102
    # K2 on (2,621,440, 128) rows: 1.51 GB
    k2 = counts.extract_candidates(2621440)
    assert round(k2[0] / 1e9, 2) == 1.51
    # K3 with 3,883 valid rows of 4096: 7.5 M pairs x 40
    k3 = counts.prune_overlap(4096, 3883)
    assert round(k3[1] / 40 / 1e6, 1) == 7.5
    # K4 on (252, 15625) uint16: 7.9 MB
    k4 = counts.tile_percentiles(252, 15625, 2)
    assert round(k4[0] / 1e6, 1) == 7.9
    peaks = roofline.PEAKS[H100]
    assert roofline.bound_s([k1], peaks) == pytest.approx(
        (3.052e-5, "bytes"), rel=1e-3)
    assert roofline.bound_s([k2], peaks)[0] == pytest.approx(4.507e-4,
                                                             rel=1e-3)
    assert roofline.bound_s([k3], peaks) == pytest.approx(
        (4.5e-6, "operations"), rel=1e-2)
    assert roofline.bound_s([k4], peaks)[0] == pytest.approx(2.35e-6,
                                                             rel=1e-2)


def test_log_counts_taps_of_each_sigma():
    nbytes, ops = counts.log_pyramid((156, 128, 128), [2.6, 2.8])
    vox = 156 * 128 * 128
    assert nbytes == vox * 4 * 3
    assert counts.taps(2.6) == 21 and counts.taps(2.8) == 23
    assert ops == vox * ((7 * 2 * 21 + 3) + (7 * 2 * 23 + 3))


def test_roofline_share():
    assert roofline.share([(3.35e12, 0.0)], 2.0, H100) == pytest.approx(50)
    assert roofline.share([(0.0, 67e12)], 4.0, H100) == pytest.approx(25)
    assert roofline.share([(1.0, 1.0)], 0.0, H100) is None
    assert roofline.share([(1.0, 1.0)], 1.0, "some other card") is None
    assert roofline.share([], 1.0, H100) is None


class Ev:
    def __init__(self, name, kind, start, end, corr=0, cuda=False, tid=1):
        self._v = (name, kind, start, end, corr, cuda, tid)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def start_thread_id(self):
        return self._v[6]


def test_summary_unions_attributes_and_labels_gaps():
    events = [
        Ev("portbench.pass", "user_annotation", 0, 100),
        Ev("portbench.log_pyramid", "user_annotation", 10, 40),
        Ev("aten::mm", "cpu_op", 12, 20),
        Ev("cudaLaunchKernel", "cuda_runtime", 15, 16, corr=7),
        Ev("sgemm", "kernel", 30, 50, corr=7, cuda=True),
        Ev("memcpy", "gpu_memcpy", 45, 55, corr=9, cuda=True),
        Ev("cudaMemcpyAsync", "cuda_runtime", 41, 42, corr=9),
        Ev("cudaLaunchKernel", "cuda_runtime", 60, 61, corr=8),
        Ev("peak_candidates_kernel", "kernel", 70, 80, corr=8, cuda=True),
        Ev("aten::item", "cpu_op", 60, 90),
        Ev("portbench.pass", "user_annotation", 5, 6, tid=2),
    ]
    t = trace.summarise(events, ["portbench.log_pyramid"])
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(35e-9)
    assert t.span_s("log_pyramid") == pytest.approx(20e-9)
    assert t.kernel_s("peak_candidates_kernel") == pytest.approx(10e-9)
    # gaps [0, 30] (halfway in aten::mm), [55, 70] and [80, 100] (halfway
    # in aten::item)
    top = t.breakdown()
    assert dict(top["idle_gaps"]) == pytest.approx(
        {"portbench.log_pyramid > aten::mm": 30e-9,
         "portbench.pass > aten::item": 35e-9})
    assert top["device_ops"][0] == ["sgemm", pytest.approx(20e-9)]


class OldEv(Ev):
    """An event of a PyTorch that gives no activity type: device spans
    mirror the host's, runtime calls go by name."""
    activity_type = property()


def test_summary_without_activity_types():
    events = [
        OldEv("portbench.pass", "", 0, 100),
        OldEv("portbench.pass", "", 0, 100, corr=3, cuda=True),
        OldEv("portbench.log_pyramid", "", 10, 40),
        OldEv("cudaLaunchKernel", "", 15, 16, corr=7),
        OldEv("sgemm", "", 30, 50, corr=7, cuda=True),
    ]
    t = trace.summarise(events, ["portbench.log_pyramid"])
    assert t.busy_s == pytest.approx(20e-9)
    assert t.span_s("log_pyramid") == pytest.approx(20e-9)
    assert [op[0] for op in t.ops] == ["sgemm"]
