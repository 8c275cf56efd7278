"""Command-line entry of the port: blob detection and its grid search.

``python -m magellanmapper_torch.io.cli --img vol.npy --proc detect
--roi_profile lightsheet [--device cuda]`` parses the reference's flags
with ``magellanmapper_tpu.io.cli.process_cli_args``, runs the port's
:func:`~magellanmapper_torch.cv.stack_detect.detect_blobs_stack`, and
writes ``blobs.npz`` and ``stack_detection_times.csv`` next to the image
as the reference's ``--proc detect`` task does.

``python -m magellanmapper_torch.io.cli --img roi.npy --grid_search
gridtest --roi_profile 4xnuc --truth_db truth.db`` runs the named
grid-search profile over the image and scores every combination against
the confirmed blobs of the truth database
(:func:`~magellanmapper_torch.stats.mlearn.grid_search_from_cli`),
writing ``<image>_gridsearch.csv`` as the reference's task does. As in the
reference, ``--grid_search`` takes precedence over ``--proc``.

Other tasks, and options the port does not have yet, are rejected;
``--truth_db`` is accepted only with ``--grid_search``.

``--device`` picks where the device step runs: ``cuda`` (the default)
fails without a card, and the CPU, which runs the kernels' plain
versions, is used only when ``--device cpu`` asks for it.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence, Union

import pandas as pd

from magellanmapper_tpu.cv import blobs as blobs_mod
from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.settings.config import ProcessTypes
from magellanmapper_tpu.utils import libmag
from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import stack_detect
from magellanmapper_torch.stats import mlearn

_logger = logging.getLogger(__name__)


def detect(rc: ref_cli.RunConfig, device) -> blobs_mod.Blobs:
    """The ``--proc detect`` task: detect, then save the blob archive and
    the stage timings next to the image."""
    img5d = ref_cli._load_image(rc)
    vol = img5d.img[0] if img5d.img.ndim >= 4 else img5d.img
    res = (img5d.resolutions[0] if img5d.resolutions is not None
           else (1.0, 1.0, 1.0))
    blobs, timing = stack_detect.detect_blobs_stack(
        vol, rc.roi_profiles or rc.roi_profile, res, channels=rc.channel,
        device=device)
    base = rc.prefix or rc.filenames[0]
    blobs.basename = os.path.basename(base)
    blobs.path = libmag.combine_paths(base, "blobs.npz")
    blobs.save_archive()
    pd.DataFrame([{k: v for k, v in timing.items()
                   if isinstance(v, (int, float))}]).to_csv(
        libmag.combine_paths(base, "stack_detection_times.csv"),
        index=False)
    _logger.info(
        "Detected %d blobs on %s in %.2fs (detection %.2fs, pruning %.2fs)",
        len(blobs), device, timing.get("Total_stack", 0),
        timing.get("Detection", 0), timing.get("Pruning", 0))
    return blobs


def main(argv: Optional[Sequence[str]] = None
         ) -> Union[blobs_mod.Blobs, pd.DataFrame]:
    """CLI entry: ``--device`` plus the reference's flags. Returns the
    detected blobs, or the grid search's table."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s:%(name)s: %(message)s")
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    rc = ref_cli.process_cli_args(rest)
    task = "--grid_search" if rc.grid_search else (
        f"--proc {rc.proc.name.lower()}" if rc.proc else None)
    unsupported = [
        flag for flag, val in (
            ("--register", rc.register_type), ("--mesh", rc.mesh),
            ("--truth_db", rc.truth_db and not rc.grid_search),
            ("--save_subimg", rc.save_subimg),
            ("--df", rc.df_task), ("--plot_2d", rc.plot_2d_task),
            ("--notify", rc.notify_url))
        if val]
    if unsupported or not (rc.grid_search or rc.proc is ProcessTypes.DETECT):
        raise SystemExit(
            "magellanmapper_torch supports only --proc detect and "
            f"--grid_search so far (got {task}"
            + (f", {' '.join(unsupported)}" if unsupported else "")
            + "); use magellanmapper_tpu.io.cli for other tasks")
    if not rc.filenames:
        raise SystemExit(f"{task} needs --img")
    device = device_mod.resolve(args.device)
    if rc.grid_search:
        _logger.info("grid search %s on %s", rc.grid_search, device)
        return mlearn.grid_search_from_cli(rc, device)
    _logger.info("detecting on %s", device)
    return detect(rc, device)


if __name__ == "__main__":
    main()
