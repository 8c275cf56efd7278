"""Driver ``detect``: whole passes of ``--proc detect`` over one channel.

Set-up makes the traffic's volume on the card from the seed and hands it
over in host memory, as the memmapped image of a whole-specimen run is;
builds the configuration's ROI profile through the program and checks it
holds every value the configuration states. The harness warms with one
whole call. A call is one pass of ``stack_detect.detect_blobs_blocks`` over the
volume, as the CLI's ``--proc detect`` makes it (the near-max measured
from the volume): host planning and slab staging, per block K4
preprocessing, the LoG pyramid, K1 and K3, the pull, the overflow
retries, then the cross-block prune. The reference is
``reference/detect.py`` on the same volume and the configuration's
profile values.
"""

from __future__ import annotations


from portbench import compare, programs
from portbench.reference import detect as ref_detect
from portbench.trace import Hook

#: the outer span of a call
SPAN = "pass"


def _cube_shape(p, out):
    return {"shape": tuple(p["vol"].shape), "sigmas": tuple(p["sigmas"])}


class Driver:
    """One cell's program, inputs and reference."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.res = tuple(float(r) for r in config["resolutions"])
        self.volume = None
        self.profile = None
        self.voxels = 0

    def setup(self) -> None:
        made = programs.generator(self.traffic["generator"]).make(
            self.traffic["params"], self.seed, self.device)
        self.volume = made["volume"]
        self.voxels = int(self.volume.size)
        self.profile = programs.roi_profile(self.config)

    def once(self) -> dict:
        from magellanmapper_torch.cv import stack_detect
        blobs, timing = stack_detect.detect_blobs_blocks(
            self.volume, self.profile, self.res, channels=[0],
            device=self.device)
        programs.synchronize(self.device)
        return {"out": blobs, "timing": timing, "voxels": self.voxels}

    def lower_precision(self):
        """The program's own lower-precision route, switched on."""
        return programs.overridden(self.profile,
                                   self.config["lower_precision"])

    def hooks(self):
        """Spans around the program's calls, and the counts the
        per-layer readers take from them."""
        pk = "magellanmapper_torch.ops.peaks"
        return [
            Hook("magellanmapper_torch.cv.stack_detect", "detect_step",
                 "detect_step"),
            Hook("magellanmapper_torch.cv.stack_detect", "prune_blobs",
                 "prune_blobs"),
            Hook("magellanmapper_torch.cv.stack_detect", "block_blobs",
                 "block_blobs"),
            Hook("magellanmapper_torch.cv.stack_detect", "preprocess_block",
                 "preprocess"),
            Hook("magellanmapper_torch.ops.filters", "log_pyramid",
                 "log_pyramid", _cube_shape, ("vol", "sigmas")),
            Hook(pk, "peak_candidates", "peak_candidates",
                 lambda p, out: {"shape": tuple(p["cube"].shape),
                                 "candidates": int(out[0].shape[0])},
                 ("cube",)),
            Hook(pk, "_peak_buffers", "peak_buffers",
                 lambda p, out: {"rows": int(p["top_v"].shape[0]),
                                 "capacity": int(p["capacity"])},
                 ("top_v", "capacity")),
            Hook(pk, "prune_overlapping_blobs", "prune_overlap"),
            Hook("magellanmapper_torch.ops.preproc", "tile_percentiles",
                 "tile_percentiles",
                 lambda p, out: {"shape": tuple(p["tiles"].shape),
                                 "itemsize": p["tiles"].element_size()},
                 ("tiles",)),
        ]

    def release(self) -> None:
        """Free what the program holds on the card."""
        self.profile = None
        programs.release(self.device)

    def reference(self):
        return ref_detect.detect(self.volume, self.config["profile"],
                                 self.res, self.device)

    def check(self, outputs, ref):
        """Each call's compared numbers: ``row_diff``, the share of rows
        that do not match the reference's."""
        return [{"row_diff": compare.share(*compare.unmatched(out, ref))}
                for out in outputs]
