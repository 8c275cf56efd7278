"""Hyperparameter grid-search profiles.

Copy of ``GridSearchProfile`` from
``magellanmapper_tpu/settings/grid_search_prof.py``: ordered mappings of
ROI-profile keys to the values that ``stats.mlearn.grid_search`` sweeps.
"""

from __future__ import annotations

import numpy as np

from magellanmapper_torch.settings.profiles import Profile


class GridSearchProfile(Profile):
    """Grid search settings profile (ordered param -> values)."""

    PATH_PREFIX = "grid"

    def __init__(self, *args, **kwargs):
        super().__init__()
        self["hyperparams"] = {}
        self.update(*args, **kwargs)

        self.profiles = {
            # basic test sweep (reference grid_search_prof.py:90)
            "gridtest": {
                "hyperparams": {
                    "detection_threshold":
                        np.arange(0.05, 0.25, 0.05).tolist(),
                },
            },
            "size5x": {
                "hyperparams": {
                    "min_sigma_factor":
                        np.arange(2.5, 3.6, 0.5).tolist(),
                    "max_sigma_factor":
                        np.arange(3.5, 4.6, 0.5).tolist(),
                },
            },
            "size4x": {
                "hyperparams": {
                    "min_sigma_factor":
                        np.arange(2.0, 3.1, 0.5).tolist(),
                    "max_sigma_factor":
                        np.arange(3.0, 4.1, 0.5).tolist(),
                },
            },
            "sizeiso": {
                "hyperparams": {
                    "min_sigma_factor": np.arange(2.0, 3.1, 0.5).tolist(),
                    "max_sigma_factor": np.arange(3.0, 4.1, 0.5).tolist(),
                    "isotropic": [(0.96, 1, 1), (1, 1, 1)],
                },
            },
        }

    def get_param_grid(self) -> dict:
        """The active hyperparameter grid (param -> list of values)."""
        return dict(self["hyperparams"] or {})


def make_hyperparm_arr(start, stop, num_steps: int, num_col: int,
                       coli: int, base=1) -> np.ndarray:
    """2D hyperparameter array varying one column over ``linspace``
    (reference ``grid_search_prof.make_hyperparm_arr :14``)."""
    arr = np.ones((num_steps, num_col)) * base
    arr[:, coli] = np.linspace(start, stop, num_steps)
    return arr
