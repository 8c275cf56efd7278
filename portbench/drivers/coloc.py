"""Driver ``coloc``: whole two-channel passes of ``--proc detect_coloc
--channel 0 1`` and then ``--proc coloc_match``, as the CLI makes them
without files.

Set-up first looks up the program's whole-image matching entry
(``colocalizer.match_stack``), so a program without it fails at once;
then makes the traffic's ``(Z, Y, X, 2)`` volume on the card from the
seed and hands it over in host memory, as the memmapped image of a
two-channel specimen is, and builds the configuration's ROI profile
through the program (checking every value the configuration states).
The harness warms with one whole call. A call: detection of both
channels (``stack_detect.detect_blobs_stack``: per channel host planning
and slab staging from the interleaved array, the block step, the
cross-block prune), each blob's intensity colocalisation in both
channels (``colocalizer.colocalize_blobs``: the ball means on the card a
slab at a time), then the channels' blobs matched over the whole image
within ``detector.calc_overlap``'s tolerance (``match_stack``: blocks of
matching, host scipy). The reference is ``reference/coloc.py``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from portbench import compare, programs
from portbench.drivers import detect as detect_driver
from portbench.reference import blobs as ref_blobs
from portbench.reference import coloc as ref_coloc
from portbench.trace import Hook

#: the outer span of a call
SPAN = "pass"
#: detected channels, as ``--channel 0 1`` gives them
CHANNELS = [0, 1]


def _ball_call(p, out):
    """What ``ball_roofline`` counts of one ``_ball_sums`` call: the
    integer coordinates it served, the channel's shape and item size,
    and the ball's radius (host arrays the program already holds)."""
    return {"coords": p["coords"], "shape": tuple(p["chl"].shape),
            "itemsize": int(p["chl"].itemsize), "radius": int(p["radius"])}


def match_rows(matches) -> dict:
    """Each channel pair's matches as ``(n, 2, 3)`` float64 z, y, x of
    the first and the second channel's blob."""
    out = {}
    for pair, bm in matches.items():
        blobs = bm.get_blobs_all()
        if blobs is None:
            continue
        out[tuple(int(c) for c in pair)] = np.stack(
            [blobs[0][:, :3], blobs[1][:, :3]], axis=1).astype(np.float64)
    return out


def _pairs(rows: np.ndarray) -> Counter:
    return Counter(map(tuple, rows.reshape(len(rows), -1).tolist()))


def match_diff(prog: dict, ref: dict) -> float:
    """Matches missing from or extra to the reference's, over the
    reference's matches, all channel pairs together."""
    missing = total = 0
    for pair in set(prog) | set(ref):
        a = _pairs(prog.get(pair, np.zeros((0, 2, 3))))
        b = _pairs(ref.get(pair, np.zeros((0, 2, 3))))
        missing += sum(((a - b) + (b - a)).values())
        total += sum(b.values())
    return compare.share(missing, total)


class Driver:
    """One cell's program, inputs and reference."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.res = tuple(float(r) for r in config["resolutions"])
        self.volume = None
        self.profile = None
        self.match = None
        self.tol = None
        self.voxels = 0

    def setup(self) -> None:
        from magellanmapper_torch.cv import colocalizer, detector
        self.match = colocalizer.match_stack
        # the task's tolerance: the detection overlap at the resolutions
        self.tol = detector.calc_overlap(self.res)
        made = programs.generator(self.traffic["generator"]).make(
            self.traffic["params"], self.seed, self.device)
        self.volume = made["volume"]
        # each voxel of the specimen once: a lab waits on the specimen,
        # not on a channel
        self.voxels = int(np.prod(self.volume.shape[:3]))
        self.profile = programs.roi_profile(self.config)

    def once(self) -> dict:
        from magellanmapper_torch.cv import colocalizer, stack_detect
        blobs, timing = stack_detect.detect_blobs_stack(
            self.volume, self.profile, self.res, channels=CHANNELS,
            device=self.device)
        colocs = colocalizer.colocalize_blobs(
            self.volume, blobs.blobs, device=self.device)
        matches = self.match(blobs.blobs, self.volume.shape[:3], self.tol)
        programs.synchronize(self.device)
        return {"out": {"blobs": blobs.blobs, "colocs": colocs,
                        "matches": match_rows(matches)},
                "timing": timing, "voxels": self.voxels}

    def lower_precision(self):
        """The program's own lower-precision route, switched on."""
        return programs.overridden(self.profile,
                                   self.config["lower_precision"])

    def hooks(self):
        """The detect driver's spans and counts, and the ball sums'."""
        return detect_driver.Driver.hooks(self) + [
            Hook("magellanmapper_torch.cv.colocalizer", "_ball_sums",
                 "ball_sums", _ball_call, ("chl", "coords", "radius"))]

    def release(self) -> None:
        """Free what the program holds on the card."""
        self.profile = None
        programs.release(self.device)

    def reference(self):
        return ref_coloc.detect(self.volume, self.config["profile"],
                                self.res, self.device, CHANNELS)

    def check(self, outputs, ref):
        """Each call's compared numbers: ``row_diff``, the share of both
        channels' rows that do not match the reference's; ``coloc_diff``,
        the share of the program's rows whose flags differ from the
        reference's flags of those rows; ``match_diff``, the share of the
        reference's matches of the program's rows that the program's
        matches miss or add."""
        assumed = self.config["assumed"]
        tol = np.ceil(ref_blobs.scaling(self.res)
                      * ref_blobs.OVERLAP_FACTOR)
        got = []
        for out in outputs:
            rows = out["blobs"]
            want_flags = ref_coloc.flags(self.volume, rows,
                                         int(assumed["ball_radius"]))
            if rows is None or out["colocs"] is None:
                coloc = 0.0 if rows is None and out["colocs"] is None \
                    else 1.0
            else:
                coloc = float(np.mean(np.any(
                    out["colocs"] != want_flags, axis=1)))
            want = ref_coloc.match(rows, self.volume.shape[:3], tol,
                                   int(assumed["match_block"]))
            got.append({
                "row_diff": compare.share(*compare.unmatched(rows, ref)),
                "coloc_diff": coloc,
                "match_diff": match_diff(out["matches"], want)})
        return got
