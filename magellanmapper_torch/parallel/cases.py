"""Rank-side calls that the tests and ``chip_smoke.py`` run in a world.

:func:`launch.run_cases` calls a port function as ``fn(*args,
mesh=mesh, **kwargs)``; the functions here wrap the sharded paths whose
signatures do not take that form (the mesh first, or a per-rank input),
and return what is compared on the host: numbers, numpy arrays and
dicts of them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import reg_engine, transform
from magellanmapper_torch.parallel import comm, halo, mesh as mesh_mod


def halo_planes(vol: np.ndarray, width: int, mesh,
                device="cuda") -> np.ndarray:
    """This rank's z-shard of ``vol`` (dealt over ``sp`` in equal
    shares) extended by :func:`halo.halo_exchange_z`."""
    n = mesh_mod.axis_size(mesh, "sp")
    per = vol.shape[0] // n
    z0 = mesh_mod.axis_index(mesh, "sp") * per
    local = torch.from_numpy(np.ascontiguousarray(vol[z0:z0 + per])).to(
        device_mod.resolve(device))
    return halo.halo_exchange_z(local, width, mesh=mesh).cpu().numpy()


def _tensors(params: Dict, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in params.items()}


def level_loss(fixed: np.ndarray, moving: np.ndarray, params: Dict,
               kind: str, metric: str, lrs, stride: Sequence[int], mesh,
               fixed_mask: Optional[np.ndarray] = None,
               moving_mask: Optional[np.ndarray] = None,
               jitter: bool = True, device="cuda") -> float:
    """The loss of one sharded level at ``params`` (0 iterations: an
    evaluation only)."""
    dev = device_mod.resolve(device)

    def t(x):
        return None if x is None else torch.from_numpy(
            np.asarray(x, np.float32)).to(dev)

    _, loss = reg_engine._optimize_level_sharded(
        mesh, t(fixed), t(moving), _tensors(params, dev), None, kind,
        metric, 0, None, tuple(lrs), tuple(stride), fixed_mask=t(fixed_mask),
        moving_mask=t(moving_mask), jitter=jitter)
    return float(loss)


def mattes_mi_grads(fixed: np.ndarray, moving: np.ndarray, params: Dict,
                    mesh, device="cuda") -> Dict[str, np.ndarray]:
    """Gradients of the sharded Mattes MI of an affine warp over every
    sample (padded to a multiple of the rank count), reduced over the
    ranks as a sharded level reduces them."""
    dev = device_mod.resolve(device)
    fixed_t = torch.from_numpy(np.asarray(fixed, np.float32)).to(dev)
    moving_t = torch.from_numpy(np.asarray(moving, np.float32)).to(dev)
    p = {k: v.requires_grad_(True) for k, v in _tensors(params,
                                                          dev).items()}
    n_ranks = mesh_mod.axis_size(mesh, mesh_mod.AXES)
    coords = transform.transform_coords(p, "affine", fixed_t.shape)
    n = fixed_t.numel()
    n_pad = -(-n // n_ranks) * n_ranks
    f = reg_engine._local_share(
        mesh, reg_engine._pad_to(fixed_t.reshape(-1), n_pad))
    c = reg_engine._pad_to(coords.reshape(3, -1), n_pad, axis=1)
    valid = reg_engine._local_share(
        mesh, reg_engine._pad_to(torch.ones(n, device=dev), n_pad))
    m = reg_engine._sharded_gather(mesh, moving_t, c)
    loss = reg_engine._sharded_metric_loss(
        mesh, "AdvancedMattesMutualInformation", f, m, valid, None)
    grads = torch.autograd.grad(loss, list(p.values()))
    grads = reg_engine._mean_grads(mesh)(grads)
    return {k: g.cpu().numpy() for k, g in zip(p, grads)}


def register_stage_t(fixed: np.ndarray, moving: np.ndarray, stage: Dict,
                     kind: str, mesh, device="cuda") -> Dict[str, np.ndarray]:
    """:func:`reg_engine.register_stage`'s parameters as numpy."""
    params, _ = reg_engine.register_stage(fixed, moving, stage, kind=kind,
                                          mesh=mesh, device=device)
    return {k: v.cpu().numpy() for k, v in params.items()}


def register_duo_dsc(fixed: np.ndarray, moving: np.ndarray, profile,
                     mesh, device="cuda") -> float:
    """:func:`reg_engine.register_duo`'s foreground DSC."""
    _, res = reg_engine.register_duo(fixed, moving, profile, mesh=mesh,
                                     device=device)
    return float(res.metrics["dsc_fixed_moved"])


def detect_multi(vol: np.ndarray, res, profile, overrides: Dict,
                 thresholds: Sequence[float], mesh, device="cuda"):
    """The blobs of :func:`stats.mlearn.make_fn_detect_multi` at
    ``thresholds``, its sweep dealt over ``mesh``."""
    from magellanmapper_torch.stats import mlearn

    fn = mlearn.make_fn_detect_multi(vol, res, profile, mesh=mesh,
                                     device=device)
    return fn(overrides, list(thresholds))


def classifier_step(params, patches: np.ndarray, labels: np.ndarray, mesh,
                    learning_rate: float = 1e-3, device="cuda"):
    """One :meth:`BlobClassifier.train_step_sharded` from ``params`` (the
    reference's tree); returns the loss, the new tree and the reduced
    gradients that the step took (the reference's layout)."""
    from magellanmapper_torch.cv import classifier

    clf = classifier.BlobClassifier(params=params, device=device)
    loss = clf.train_step_sharded(mesh, patches, labels, learning_rate)
    grads = classifier.params_to_reference(
        {k: p.grad for k, p in clf.model.named_parameters()})
    return loss, clf.params, grads


def group_grads(imgs: Sequence[np.ndarray], params: Dict, mesh=None,
                device="cuda") -> Dict[str, np.ndarray]:
    """The gradient of the groupwise affine loss of same-shape ``imgs`` at
    full resolution on the metric stride, at ``params`` (``W (K, 3, 3)``,
    ``t (K, 3)``), with respect to every image's parameters: the images
    dealt over ``mesh``'s first axis as :func:`reg_engine.register_groupwise`
    deals them, each rank's gradient scaled as its level scales it and
    gathered; or in one process without ``mesh``."""
    dev = device_mod.resolve(device)
    k = len(imgs)
    lo, hi, n = 0, k, 1
    if mesh is not None:
        axis = mesh_mod.AXES[0]
        n = mesh_mod.axis_size(mesh, axis)
        lo, hi = mesh_mod.shard_bounds(k, n, mesh_mod.axis_index(mesh, axis))
    vols = torch.from_numpy(np.stack([np.asarray(im, np.float32)
                                      for im in imgs[lo:hi]])).to(dev)
    p = {name: torch.from_numpy(np.asarray(v, np.float32)[lo:hi]).to(
        dev).requires_grad_(True) for name, v in params.items()}
    loss = reg_engine._group_loss_fn(
        vols, reg_engine._metric_stride(vols.shape[1:]), None, mesh, k)(p)
    grads = [g / n for g in torch.autograd.grad(loss, list(p.values()))]
    if mesh is not None:
        grads = [comm.all_gather(g, mesh, mesh_mod.AXES[0]) for g in grads]
    return {name: g.cpu().numpy() for name, g in zip(p, grads)}


def error_of(fn: str, *args, mesh=None, **kwargs) -> Optional[str]:
    """The ``"Type: message"`` of what ``fn(*args, mesh=mesh, **kwargs)``
    raises, or None; a call that must fail on every rank alike, checked
    without ending the world."""
    from magellanmapper_torch.parallel import launch

    try:
        launch._resolve(fn)(*args, mesh=mesh, **kwargs)
    except Exception as err:  # noqa: BLE001 - the failure is the result
        return f"{type(err).__name__}: {err}"
    return None


def segment_sums(labels: np.ndarray, intensity: np.ndarray, mesh=None,
                 device="cuda") -> list:
    """The per-label sums of ``vols.measure_labels_metrics`` (count,
    intensity and its square, as numpy; labels of both sides combined):
    dealt over ``mesh`` (``vols._segment_stats_sharded``), or in one pass
    without it."""
    from magellanmapper_torch.stats import vols

    dev = device_mod.resolve(device)
    work = torch.abs(vols._to_device(labels, dev).to(torch.int64))
    ids = torch.unique(work)
    ids = ids[ids != 0]
    codes = vols._dense_code(work.reshape(-1), ids)
    vals = vols._to_device(np.asarray(intensity, np.float32).reshape(-1),
                           dev)
    n = len(ids) + 1
    sums = (vols._segment_stats(codes, vals, None, n) if mesh is None else
            vols._segment_stats_sharded(codes, vals, None, n, mesh))
    return [s.cpu().numpy() for s in sums[:3]]
