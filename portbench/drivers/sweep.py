"""Driver ``sweep``: whole calls of the ``--grid_search`` threshold sweep
on one ROI.

Set-up makes the traffic's ROI and its truth set on the card from the
seed and hands them over in host memory; builds the configuration's ROI
profile through the program (checked against the values the
configuration states) and the sweep's grid from the configuration's
``hyperparams``; checks that the batched path applies, as
``grid_search_from_cli`` would find. The harness warms with one call. A
call is
what ``grid_search_from_cli`` runs without the file read and the CSV:
``make_fn_detect_multi`` (the ROI to the card), ``grid_search`` (one LoG
pyramid, K2 and K3 per threshold, verification of each threshold against
the truth on the host) and ``parse_grid_stats``. The harness's
``fn_detect_multi`` records each threshold's blobs, and each call
records the seconds spent in the program's ``cv/verifier.verify_stack``.
The reference is ``reference/sweep.py``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from portbench import compare, programs
from portbench.reference import blobs as ref_blobs
from portbench.reference import sweep as ref_sweep
from portbench.trace import Hook

#: the outer span of a call
SPAN = "sweep"
#: the score columns the program's table and the reference's share
COLUMNS = ("POS", "TP", "FP", "FN", "FDR", "SENS", "PPV")


def _no_plain_path(overrides):
    raise RuntimeError("the sweep left its batched path")


class Driver:
    """One cell's program, inputs and reference."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.res = tuple(float(r) for r in config["resolutions"])
        self.roi = self.truth = self.profile = None
        self.grid = OrderedDict(
            (k, list(v)) for k, v in config["hyperparams"].items())

    def setup(self) -> None:
        from magellanmapper_torch.cv import detector
        from magellanmapper_torch.stats import mlearn
        made = programs.generator(self.traffic["generator"]).make(
            self.traffic["params"], self.seed, self.device)
        self.roi = made["volume"]
        centres = made["centres"].astype(float)
        self.truth = np.column_stack([centres, np.full(len(centres), 3.0)])
        self.profile = programs.roi_profile(self.config)
        programs.check_grid(self.config)
        if not mlearn.multi_path_applicable(
                self.roi, self.grid.keys(), self.profile):
            raise RuntimeError("the batched sweep does not apply to this "
                               "ROI and grid")
        self.tol = detector.calc_overlap(self.res) * np.asarray(
            self.profile["verify_tol_factor"])

    def once(self) -> dict:
        from magellanmapper_torch.stats import mlearn
        rows = []
        with programs.timed("magellanmapper_torch.cv.verifier",
                            "verify_stack") as verify_s:
            fn = mlearn.make_fn_detect_multi(
                self.roi, self.res, self.profile, self.device)

            def fn_multi(other, thresholds):
                out = fn(other, thresholds)
                rows.extend(out)
                return out

            df = mlearn.grid_search(self.grid, _no_plain_path, self.truth,
                                    self.tol, fn_detect_multi=fn_multi)
            df = mlearn.parse_grid_stats(df)
            programs.synchronize(self.device)
        table = {float(r["detection_threshold"]): [r[c] for c in COLUMNS]
                 for r in df.to_dict("records")}
        return {"out": (rows, table), "verify_s": verify_s[0]}

    def lower_precision(self):
        """The program's own lower-precision route, switched on."""
        return programs.overridden(self.profile,
                                   self.config["lower_precision"])

    def hooks(self):
        pk = "magellanmapper_torch.ops.peaks"
        return [
            Hook("magellanmapper_torch.cv.verifier", "verify_stack",
                 "verify"),
            Hook("magellanmapper_torch.ops.filters", "log_pyramid",
                 "log_pyramid", lambda p, out: {
                     "shape": tuple(p["vol"].shape),
                     "sigmas": tuple(p["sigmas"])}, ("vol", "sigmas")),
            Hook(pk, "local_maxima", "local_maxima"),
            Hook(pk, "_masked_fields", "masked_fields"),
            Hook("magellanmapper_torch.kernels.extract_candidates",
                 "extract_candidates", "extract_candidates",
                 lambda p, out: {"rows": int(p["rows"].shape[0])},
                 ("rows",)),
            Hook(pk, "_peak_buffers", "peak_buffers",
                 lambda p, out: {"rows": int(p["top_v"].shape[0]),
                                 "capacity": int(p["capacity"])},
                 ("top_v", "capacity")),
            Hook(pk, "prune_overlapping_blobs", "prune_overlap"),
        ]

    def release(self) -> None:
        self.profile = None
        programs.release(self.device)

    def reference(self):
        """Each threshold's rows, by the reference alone."""
        thresholds = self.grid["detection_threshold"]
        return ref_sweep.sweep(self.roi, self.config["profile"], self.res,
                               thresholds, self.device)

    def check(self, outputs, ref):
        """Each call's numbers: ``rank_diff``, the share of rows, over
        every threshold, that the reference does not hold or holds in
        another place of its order (value descending); ``table_diff``,
        the cells of the program's score table that differ from the
        scores that the reference's verification gives the program's own
        rows; and, not compared, ``row_diff``, the rows without an equal
        row alone."""
        thresholds = self.grid["detection_threshold"]
        tol = np.ceil(1.0 / np.asarray(self.res) * ref_blobs.OVERLAP_FACTOR
                      ) * np.asarray(self.config["profile"]
                                     ["verify_tol_factor"])
        out = []
        for rows, table in outputs:
            missing = moved = total = 0
            for k in range(max(len(rows), len(ref))):
                got = rows[k] if k < len(rows) else None
                want = ref[k] if k < len(ref) else None
                m, t = compare.unmatched(got, want)
                missing, total = missing + m, total + t
                moved += compare.out_of_order(got, want)
            cells = 0
            for thr, got in zip(thresholds, rows):
                want = ref_blobs.score(got, self.truth, tol)
                have = table.get(float(thr))
                if have is None:
                    cells += len(COLUMNS)
                    continue
                cells += sum(a != want[c] for a, c in zip(have, COLUMNS))
            out.append({"rank_diff": compare.share(missing + moved, total),
                        "row_diff": compare.share(missing, total),
                        "table_diff": float(cells)})
        return out
