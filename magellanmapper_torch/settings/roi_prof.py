"""ROI (detection) profiles.

Copy of ``magellanmapper_tpu/settings/roi_prof.py``: the same keys,
defaults and built-in modifier profiles, so a profile chain such as
``lightsheet`` or ``4xnuc`` gives the port the values it gives the
reference.
"""

from __future__ import annotations

from magellanmapper_torch.settings.profiles import Profile

#: keys that must match for channels to share detection blocks
#: (reference ``roi_prof.py:35`` ``BLOCK_SIZES``).
BLOCK_SIZES = (
    "segment_size",
    "denoise_size",
    "prune_tol_factor",
    "sub_stack_max_pixels",
    "isotropic",
)

#: preprocessing keys applied to each denoise sub-block
#: (reference ``roi_prof.py:26`` ``BLOB_PREPROCESSING``).
BLOB_PREPROCESSING = (
    "clip_vmin",
    "clip_vmax",
    "clip_min",
    "clip_max",
    "max_thresh_factor",
    "tot_var_denoise",
    "unsharp_strength",
    "erosion_threshold",
    "adapt_hist_lim",
)

class ROIProfile(Profile):
    """Detection settings profile (reference ``ROIProfile``)."""

    PATH_PREFIX = "roi"

    def __init__(self, *args, **kwargs):
        super().__init__()

        # visualization
        self["vis_3d"] = "points"
        self["points_3d_thresh"] = 0.85
        self["channel_colors"] = None
        self["scale_bar_color"] = "w"
        self["colorbar"] = None
        self["load_rot90"] = 0
        self["norm"] = None

        # preprocessing before blob detection (defaults per reference
        # roi_prof.py:74-88)
        self["clip_vmin"] = 5
        self["clip_vmax"] = 99.5
        self["clip_min"] = 0.2
        self["clip_max"] = 1.0
        self["max_thresh_factor"] = 0.5
        self["tot_var_denoise"] = None
        self["unsharp_strength"] = 0.3
        self["erosion_threshold"] = 0.2
        self["adapt_hist_lim"] = 0.1

        # 3D blob detection (reference roi_prof.py:91-99)
        self["min_sigma_factor"] = 3
        self["max_sigma_factor"] = 5
        self["num_sigma"] = 10
        self["detection_threshold"] = 0.1
        self["overlap"] = 0.5
        self["thresholding"] = None
        self["thresholding_size"] = -1
        self["exclude_border"] = None

        # block processing; mp_* keys retained for profile compatibility
        # (blocks run on the device, not in worker processes)
        self["mp_start"] = "fork"
        self["mp_max_tasks"] = None
        self["segment_size"] = 500
        self["denoise_size"] = 25
        self["prune_tol_factor"] = (1, 1, 1)
        self["verify_tol_factor"] = (1, 1, 1)
        self["sub_stack_max_pixels"] = (1000, 1000, 1000)
        self["isotropic"] = None
        self["isotropic_vis"] = (1, 1, 1)
        self["resize_blobs"] = None
        self["spectral_unmixing"] = None

        # fixed per-block blob capacity and the LoG pyramid's compute
        # dtype (the reference's keys)
        self["max_blobs_per_block"] = 4096
        self["log_dtype"] = "float32"

        self.update(*args, **kwargs)

        # built-in modifier profiles; values mirror the reference's
        # (roi_prof.py:147-334) for drop-in compatibility
        self.profiles = {
            "lightsheet": {
                "points_3d_thresh": 0.7,
                "clip_vmax": 98.5,
                "clip_min": 0,
                "clip_max": 0.5,
                "unsharp_strength": 0.3,
                "erosion_threshold": 0.3,
                "min_sigma_factor": 2.6,
                "max_sigma_factor": 2.8,
                "num_sigma": 10,
                "overlap": 0.55,
                "segment_size": 150,
                "prune_tol_factor": (1, 0.9, 0.9),
                "verify_tol_factor": (3, 1.2, 1.2),
                "isotropic": (0.96, 1, 1),
                "isotropic_vis": (0.5, 1, 1),
                "sub_stack_max_pixels": (1200, 800, 800),
                "exclude_border": (1, 0, 0),
            },
            "minpreproc": {
                "clip_vmin": 0,
                "clip_vmax": 99.99,
                "clip_max": 1,
                "tot_var_denoise": 0.01,
                "unsharp_strength": 0,
                "erosion_threshold": 0,
            },
            "lowres": {
                "min_sigma_factor": 10,
                "max_sigma_factor": 14,
                "isotropic": None,
                "denoise_size": 2000,
                "segment_size": 1000,
                "max_thresh_factor": 1.5,
                "exclude_border": (8, 1, 1),
                "verify_tol_factor": (3, 2, 2),
            },
            "2p20x": {
                "vis_3d": "surface",
                "clip_vmax": 97,
                "clip_min": 0,
                "clip_max": 0.7,
                "tot_var_denoise": True,
                "unsharp_strength": 2.5,
                "min_sigma_factor": 2.6,
                "max_sigma_factor": 4,
                "num_sigma": 20,
                "overlap": 0.1,
                "thresholding": None,
                "thresholding_size": 64,
                "denoise_size": 25,
                "segment_size": 100,
                "prune_tol_factor": (1.5, 1.3, 1.3),
            },
            "zebrafish": {
                "min_sigma_factor": 2.5,
                "max_sigma_factor": 3,
            },
            "contrast": {
                "channel_colors": ("inferno", "inferno"),
                "scale_bar_color": "w",
            },
            "bone": {
                "channel_colors": ("bone", "bone"),
                "scale_bar_color": "w",
            },
            "diverging": {
                "channel_colors": ("RdBu", "BrBG"),
                "scale_bar_color": "k",
                "colorbar": {"shrink": 0.7},
            },
            "cytoplasm": {
                "clip_min": 0.3,
                "clip_max": 0.8,
                "points_3d_thresh": 0.7,
                "min_sigma_factor": 4,
                "max_sigma_factor": 10,
                "num_sigma": 10,
                "overlap": 0.2,
            },
            "isotropic": {
                "points_3d_thresh": 0.3,
                "isotropic_vis": (1, 1, 1),
            },
            "binary": {
                "denoise_size": None,
                "detection_threshold": 0.001,
            },
            "4xnuc": {
                "min_sigma_factor": 3,
                "max_sigma_factor": 4,
            },
            "20x": {
                "segment_size": 50,
            },
            "exportdl": {
                "isotropic": (0.93, 1, 1),
            },
            "downiso": {
                "isotropic": None,
                "resize_blobs": (.2, 1, 1),
            },
            "rot180": {
                "load_rot90": 2,
            },
            "register": {
                "unsharp_strength": 1.5,
            },
            "atlas": {
                "channel_colors": ("gray",),
                "clip_vmax": 97,
            },
            "norm": {
                "norm": (0.0, 1.0),
            },
            "spawn": {
                "mp_start": "spawn",
            },
        }


def is_identical_block_settings(profs) -> bool:
    """True if all profiles share identical block geometry keys.

    Channels with identical block settings are detected over the same device
    blocks in one pass (reference ``roi_prof.py`` block grouping semantics).
    """
    first = profs[0]
    return all(
        all(p[k] == first[k] for k in BLOCK_SIZES) for p in profs[1:])
