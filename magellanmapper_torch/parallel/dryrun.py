"""A dry run of every sharded path on tiny shapes.

Counterpart of ``dryrun_multichip`` in the reference's
``__graft_entry__.py`` (``:68-265``): :func:`dryrun_multichip` starts a
world of ``n_ranks`` (:func:`launch.spawn`) and runs, once each, the
sharded detection step over a ``(dp, sp, spy)`` mesh, the data-parallel
classifier step, blocks dealt over the ranks, the threshold sweep, one
Mattes-MI registration level over every axis, the film-sharded renderer,
the sharded regional statistics and a batch of tile-pair phase
correlations dealt over the ranks, then prints one summary line.

``python -m magellanmapper_torch.parallel.dryrun N [--device cpu]
[--backend gloo]``
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.parallel import comm, launch, mesh as mesh_mod


def _dryrun_rank(n_ranks: int, device: str) -> str:
    """Every sharded path once on this rank; returns the summary line."""
    from magellanmapper_torch.atlas import reg_engine, transform
    from magellanmapper_torch.cv import classifier, detector
    from magellanmapper_torch.ops import render3d
    from magellanmapper_torch.parallel import distributed, halo
    from magellanmapper_torch.settings.roi_prof import ROIProfile
    from magellanmapper_torch.stats import vols
    from magellanmapper_torch.stitch import stitcher

    dev = device_mod.resolve(device)
    if n_ranks % 8 == 0:
        dp, spy = 2, 2
    elif n_ranks % 2 == 0 and n_ranks > 1:
        dp, spy = 2, 1
    else:
        dp, spy = 1, 1
    sp = n_ranks // (dp * spy)
    mesh = mesh_mod.make_mesh(n_ranks, dp=dp, sp=sp, spy=spy)
    mesh_dp = mesh_mod.make_mesh(n_ranks, dp=n_ranks, sp=1)

    shard_z, shard_y, x = 8, 16, 32
    sigmas = tuple(float(s) for s in detector.sigma_list(1.5, 3.0, 3))
    prep = (
        ("clip_vmin", 5.0), ("clip_vmax", 99.5), ("max_thresh", 0.5),
        ("clip_min", 0.2), ("clip_max", 1.0), ("tot_var_denoise", 0.0),
        ("unsharp_strength", 0.3), ("erosion_threshold", 0.2),
    )
    step = halo.make_sharded_detector(
        mesh, (shard_z, shard_y, x), 2, sigmas, 0.1, 0.5, 64,
        denoise_shape=(8, 8, 8), preproc_items=prep,
        true_extent=(shard_z * sp, shard_y * spy), device=dev)
    rng = np.random.default_rng(0)
    vol = rng.random((dp, shard_z * sp, shard_y * spy, x), dtype=np.float32)
    raw, valid = step(vol)
    assert tuple(raw.shape) == (dp, sp * spy * 64, 4), raw.shape
    assert tuple(valid.shape) == (dp, sp * spy * 64)

    patches = rng.random(
        (n_ranks * 4, classifier.PATCH_SIZE, classifier.PATCH_SIZE),
        dtype=np.float32)
    labels = (rng.random(n_ranks * 4) > 0.5).astype(np.float32)
    loss = classifier.BlobClassifier(device=dev).train_step_sharded(
        mesh_dp, patches, labels)
    assert np.isfinite(loss)

    prof = ROIProfile()
    prof["segment_size"] = 24
    prof["denoise_size"] = None
    prof["min_sigma_factor"] = 1.5
    prof["max_sigma_factor"] = 3.0
    prof["num_sigma"] = 3
    prof["max_blobs_per_block"] = 128
    vol_blocks = np.zeros((16, 48, 48), np.float32)
    zz, yy, xx = np.indices((16, 48, 48)).astype(np.float32)
    for cz, cy, cx in rng.uniform(6, 40, (8, 3)) * [[0.3, 1.0, 1.0]]:
        vol_blocks += np.exp(
            -((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
    vol_blocks = (vol_blocks / max(vol_blocks.max(), 1e-6)).astype(
        np.float32)
    blk_blobs, _ = distributed.detect_blobs_blocks_sharded(
        vol_blocks, prof, (1.0, 1.0, 1.0), mesh=mesh_dp, device=dev)
    n_blk = 0 if blk_blobs is None else len(blk_blobs)
    assert n_blk > 0, "blocks over ranks found no blobs"

    sw_raws, sw_valids = detector.blob_log_multi_sharded(
        vol_blocks, sigmas, [0.05, 0.1, 0.2, 0.4, 0.6], 0.5, 64, mesh_dp,
        device=dev)
    sw_counts = [int(v.sum()) for v in sw_valids]
    assert sw_raws.shape == (5, 64, 4)
    assert sw_counts[0] >= sw_counts[-1] and sw_counts[0] > 0, sw_counts

    reg_shape = (12, 16, 14)
    zzr, yyr, xxr = np.indices(reg_shape).astype(np.float32)
    reg_fixed = np.zeros(reg_shape, np.float32)
    for cz, cy, cx in rng.uniform(3, 10, (10, 3)):
        reg_fixed += np.exp(
            -((zzr - cz) ** 2 + (yyr - cy) ** 2 + (xxr - cx) ** 2) / 4.0)
    reg_fixed /= reg_fixed.max()
    fixed_t = torch.from_numpy(reg_fixed).to(dev)
    moving_t = transform.resample(
        fixed_t, {"t": torch.tensor([1.0, -1.0, 0.5], device=dev)},
        "translation", reg_shape)
    reg_params, reg_loss = reg_engine._optimize_level_sharded(
        mesh, fixed_t, moving_t, transform.identity_params("affine",
                                                           device=dev),
        None, "affine", "AdvancedMattesMutualInformation", 8, None,
        (("W", 0.01), ("t", 1.0)))
    reg_loss = float(reg_loss)
    assert np.isfinite(reg_loss), reg_loss
    assert all(bool(torch.isfinite(v).all()) for v in reg_params.values())

    rz, ry, rx = np.ogrid[:12, :12, :12]
    rvol = np.exp(-(((rz - 6.0) ** 2 + (ry - 6.0) ** 2
                     + (rx - 6.0) ** 2) / 12.0)).astype(np.float32)
    frame = render3d.render_volume_sharded(
        rvol, mesh_dp, 30.0, 20.0, out_hw=(n_ranks * 4, 16), n_steps=16,
        opacity=0.2, device=dev).cpu().numpy()
    assert frame.shape == (n_ranks * 4, 16, 3), frame.shape
    assert np.isfinite(frame).all() and frame.max() > 0.01

    vs_labels = rng.integers(0, 4, (10, 11, 12)).astype(np.int32)
    vs_atlas = rng.random((10, 11, 12)).astype(np.float32)
    df_vs = vols.measure_labels_metrics(vs_atlas, vs_labels, mesh=mesh,
                                        device=dev)
    df_vs_ref = vols.measure_labels_metrics(vs_atlas, vs_labels, device=dev)
    assert np.array_equal(df_vs["VolPx"], df_vs_ref["VolPx"])
    assert np.allclose(df_vs["MeanIntensity"], df_vs_ref["MeanIntensity"],
                       rtol=1e-12)

    # tile pairs dealt over the ranks, each rank correlating its own
    tiles_a = rng.random((n_ranks, 8, 32, 32), dtype=np.float32)
    tiles_b = np.roll(tiles_a, shift=(0, 2, 3), axis=(1, 2, 3))
    me = mesh_mod.axis_index(mesh_dp, mesh_mod.AXES)
    surf = stitcher._phase_corr_surface(
        stitcher._spectrum(tiles_a[me], dev),
        stitcher._spectrum(tiles_b[me], dev), (8, 32, 32))
    peaks_flat = comm.all_gather(
        torch.argmax(surf).reshape(1), mesh_dp).cpu().numpy()
    peak_zyx = np.unravel_index(int(peaks_flat[0]), (8, 32, 32))
    # b = roll(a, (0, 2, 3)) peaks at the wrapped negative shift
    assert tuple(int(v) for v in peak_zyx) == (0, 30, 29), peak_zyx
    assert len(set(peaks_flat.tolist())) == 1, peaks_flat

    return (f"dryrun_multichip OK: mesh dp={dp} sp={sp} spy={spy}, "
            f"blobs buffer {tuple(raw.shape)}, {int(valid.sum())} valid; "
            f"dp-sharded classifier train step loss {loss:.4f}; "
            f"blocks-over-ranks {n_blk} blobs; "
            f"mesh-sharded reg level (all-reduced MI histogram) "
            f"loss {reg_loss:.4f}; "
            f"dp-sharded threshold sweep counts {sw_counts}; "
            f"film-sharded render {frame.shape}; "
            f"mesh-sharded regional stats {len(df_vs)} labels; "
            f"stitch FFT pairs peak shift "
            f"{tuple(int(v) for v in peak_zyx)}")


def dryrun_multichip(n_ranks: int, backend: Optional[str] = None,
                     device="cuda", timeout_s: float = 600.0) -> str:
    """Run every sharded path once in a world of ``n_ranks`` on
    ``device`` (``backend`` as :func:`launch.spawn` takes it: ``"gloo"``
    shares one card among the ranks); prints and returns the summary
    line."""
    line = launch.spawn(_dryrun_rank, n_ranks, backend=backend,
                        device=device, timeout_s=timeout_s,
                        args=(n_ranks, str(device)))[0]
    print(line)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    dryrun_multichip(a.n_ranks, backend=a.backend, device=a.device)
