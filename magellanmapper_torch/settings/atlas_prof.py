"""Atlas (registration/curation) profiles.

Copy of ``magellanmapper_tpu/settings/atlas_prof.py`` (``RegKeys``,
``make_reg_param_map``, ``AtlasProfile`` with every named profile): three
registration stages (translation 2048 iterations -> affine 1024 ->
B-spline 512 with a 50-voxel grid), label-curation groups (mirroring,
edge extension, smoothing), and edge-aware reannotation parameters. The
values drive the port's registration engine
(:mod:`magellanmapper_torch.atlas.reg_engine`).
"""

from __future__ import annotations

from magellanmapper_torch.settings.profiles import Profile


#: nested-dict keys reused across profile groups (reference
#: ``profiles.py:25`` ``RegKeys``).
class RegKeys:
    ACTIVE = "active"
    SAVE_STEPS = "save_steps"
    MARKER_EROSION = "marker_erosion"
    MARKER_EROSION_MIN = "marker_erosion_min"
    MARKER_EROSION_USE_MIN = "marker_erosion_use_min"
    SKELETON_EROSION = "skeleton_erosion"
    WATERSHED_MASK_FILTER = "watershed_mask_filter"
    EDGE_AWARE_REANNOTATION = "edge_aware_reannotation"
    METRICS_CLUSTER = "metrics_cluster"
    DBSCAN_EPS = "dbscan_eps"
    DBSCAN_MINPTS = "dbscan_minpts"
    KNN_N = "knn_n"


def make_reg_param_map(
        map_name: str, max_iter: int, metric="AdvancedMattesMutualInformation",
        num_resolutions: int = 4, grid_space_voxels=None,
        grid_spacing_schedule=None, erode_mask=False, point_based=False,
        learning_rate=None, num_spatial_samples=None,
        pyramid_mode=None) -> dict:
    """One registration stage's parameters as a plain dict.

    Key names follow the reference ``RegParamMap`` so YAML atlas profiles
    carry over unchanged. ``num_spatial_samples`` mirrors Elastix's
    ``NumberOfSpatialSamples`` (metric sample budget per iteration); the
    engine default is 32768 on a strided grid.
    """
    return {
        "map_name": map_name,
        "metric_similarity": metric,
        "max_iter": int(max_iter),
        "num_resolutions": int(num_resolutions),
        "grid_space_voxels": grid_space_voxels,
        "grid_spacing_schedule": grid_spacing_schedule,
        "erode_mask": erode_mask,
        "point_based": point_based,
        "learning_rate": learning_rate,
        "num_spatial_samples": num_spatial_samples,
        # "smoothing" = constant-shape FixedSmoothingImagePyramid (one
        # compiled program per stage, full max_iter per level);
        # None/"downsample" = recursive half-res pyramid
        "pyramid_mode": pyramid_mode,
    }


class AtlasProfile(Profile):
    """Registration + atlas-curation settings profile."""

    PATH_PREFIX = "atlas"

    def __init__(self, *args, **kwargs):
        super().__init__()

        # registration stages (defaults per reference atlas_prof.py:53-69)
        self["reg_translation"] = make_reg_param_map("translation", 2048)
        self["reg_affine"] = make_reg_param_map("affine", 1024)
        self["reg_bspline"] = make_reg_param_map(
            "bspline", 512, grid_space_voxels=50)
        self["metric_sim_fallback"] = None
        self["groupwise_iter_max"] = 1024
        self["preprocess"] = False
        self["curate"] = True
        self["truncate_labels"] = None

        # label curation
        self["smoothing_mode"] = "opening"
        self["smooth"] = None
        self["labels_mirror"] = {
            RegKeys.ACTIVE: False,
            "start": None,
            "neg_labels": True,
            "atlas_mirror": True,
        }
        self["labels_edge"] = {
            RegKeys.ACTIVE: False,
            RegKeys.SAVE_STEPS: False,
            "start": None,
            "surr_size": 5,
            "smoothing_size": 3,
            "in_paint": True,
            RegKeys.MARKER_EROSION: 10,
            RegKeys.MARKER_EROSION_MIN: None,
            RegKeys.MARKER_EROSION_USE_MIN: False,
            "wt_lat": 0,
        }
        self["labels_dup"] = None
        self["expand_labels"] = None
        self["crop_out_labels"] = None
        self["rotate"] = {"rotation": None, "resize": False, "order": 1}
        self["atlas_threshold"] = 10.0
        self["atlas_threshold_all"] = 10.0
        self["target_size"] = None
        self["rescale"] = None
        self["carve_threshold"] = None
        self["holes_area"] = None
        self["extend_borders"] = None
        self["affine"] = None
        self["log_sigma"] = 5
        self["log_atlas_thresh"] = False
        self[RegKeys.EDGE_AWARE_REANNOTATION] = {
            RegKeys.MARKER_EROSION: 8,
            RegKeys.MARKER_EROSION_MIN: 1,
            RegKeys.SKELETON_EROSION: None,
            RegKeys.WATERSHED_MASK_FILTER: ("opening", 2),
        }
        self["erosion_frac"] = 0.5
        self["erode_labels"] = {"markers": True, "interior": False}
        self["crop_to_labels"] = False
        self["crop_to_orig"] = 1
        self["crop_to_first_image"] = False
        self["combine_sides"] = False
        self["make_far_hem_neg"] = False
        self["pre_plane"] = None
        self["overlap_meas_add_lbls"] = None

        # metrics
        self["meas_smoothing"] = True
        self["meas_edge_dists"] = True
        self["extra_metric_groups"] = None
        self[RegKeys.METRICS_CLUSTER] = {
            RegKeys.KNN_N: 5,
            RegKeys.DBSCAN_EPS: 20,
            RegKeys.DBSCAN_MINPTS: 6,
        }
        self["unit_factor"] = None

        self.update(*args, **kwargs)

        self.profiles = {
            # turn off B-spline (affine-only) registration
            "noaffine": {
                "reg_affine": None,
            },
            "nobspline": {
                "reg_bspline": None,
            },
            # normalized cross-correlation similarity metric
            "ncc": {
                "reg_translation": {
                    "metric_similarity": "AdvancedNormalizedCorrelation"},
                "reg_affine": {
                    "metric_similarity": "AdvancedNormalizedCorrelation"},
                "reg_bspline": {
                    "metric_similarity": "AdvancedNormalizedCorrelation"},
                "metric_sim_fallback":
                    (0.85, "AdvancedMattesMutualInformation"),
            },
            # groupwise registration: coarser B-spline grid + schedule
            "groupwise": {
                "reg_bspline": {
                    "grid_space_voxels": 130,
                    "grid_spacing_schedule": [
                        8.0, 8.0, 4.0, 4.0, 4.0, 2.0, 2.0, 2.0, 1.0, 1.0,
                        1.0, 1.0],
                },
                "carve_threshold": 0.009,
                "holes_area": 10000,
            },
            # finer B-spline for higher-res atlases
            "finer": {
                "reg_bspline": {"grid_space_voxels": 30},
            },
            # increased iterations
            "bigiter": {
                "reg_translation": {"max_iter": 4096},
                "reg_affine": {"max_iter": 2048},
                "reg_bspline": {"max_iter": 1024},
            },
            "smalliter": {
                "reg_translation": {"max_iter": 512},
                "reg_affine": {"max_iter": 256},
                "reg_bspline": {"max_iter": 128},
            },
            # turn off label mirroring / edge extension
            "nomirror": {"labels_mirror": {RegKeys.ACTIVE: False}},
            "mirror": {"labels_mirror": {RegKeys.ACTIVE: True, "start": -1}},
            "noedge": {"labels_edge": {RegKeys.ACTIVE: False}},
            "edge": {"labels_edge": {RegKeys.ACTIVE: True, "start": -1}},
            # smoothing sweeps
            "smooth2": {"smooth": 2},
            "smooth4": {"smooth": 4},
            "smoothgaus": {"smoothing_mode": "gaussian"},
            "smoothfill": {"smoothing_mode": "filled"},
            # point-based (landmark) registration assist
            "points": {
                "reg_bspline": {"point_based": True},
            },
            # combine hemisphere values in regional stats
            "combinesides": {"combine_sides": True},

            # ADMBA developing-mouse atlases (key curation values per
            # reference atlas_prof.py:376-716)
            "abae11pt5": {
                "target_size": (345, 371, 158),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.52},
                "labels_edge": {RegKeys.ACTIVE: False, "start": None},
                "log_atlas_thresh": True,
                "atlas_threshold": 75,
                "atlas_threshold_all": 5,
                "rotate": {"rotation": ((-5, 1), (-1, 2), (-30, 0)),
                           "resize": False},
            },
            "abae13pt5": {
                "target_size": (552, 673, 340),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.48},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1},
                "atlas_threshold": 55,
                "rotate": {"rotation": ((-4, 1), (-2, 2)),
                           "resize": False},
                "crop_to_labels": True,
            },
            "abae15pt5": {
                "target_size": (704, 982, 386),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.49},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1,
                                "surr_size": 12, "smoothing_size": 5,
                                RegKeys.MARKER_EROSION: 19},
                "atlas_threshold": 45,
                "rotate": {"rotation": ((-4, 1),), "resize": False},
            },
            "abae18pt5": {
                "target_size": (278, 581, 370),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.525},
                "labels_edge": {RegKeys.ACTIVE: True, "start": 0.137,
                                "surr_size": 12,
                                RegKeys.MARKER_EROSION: 12,
                                RegKeys.MARKER_EROSION_USE_MIN: True},
                "rotate": {"rotation": ((1.5, 1), (2, 2)),
                           "resize": False},
                "smooth": 3,
            },
            "abap4": {
                "target_size": (724, 403, 398),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.487},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1,
                                "surr_size": 12,
                                RegKeys.MARKER_EROSION: 8},
            },
            "abap14": {
                "target_size": (390, 794, 469),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.5},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1},
            },
            "abap28": {
                "target_size": (863, 480, 418),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.48},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1},
            },
            "abap56": {
                "target_size": (528, 320, 456),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.5},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1},
            },
            "abaadult": {
                "target_size": (528, 320, 456),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": 0.5},
                "labels_edge": {RegKeys.ACTIVE: True, "start": -1},
            },
            "abaccfv3": {
                "target_size": (528, 320, 456),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": None},
                "labels_edge": {RegKeys.ACTIVE: False, "start": None},
                "smooth": 2,
            },
            "whsrat": {
                "target_size": (441, 1017, 383),
                "labels_mirror": {RegKeys.ACTIVE: True, "start": None},
                "labels_edge": {RegKeys.ACTIVE: False, "start": None},
                "smooth": 4,
            },
        }
