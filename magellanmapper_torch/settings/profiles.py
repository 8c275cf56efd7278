"""Layered settings profiles.

Copy of ``Profile`` from ``magellanmapper_tpu/settings/profiles.py``: a
base dictionary of defaults over which named *modifier* profiles are
applied left to right from a comma-delimited chain; a profile may also be
a YAML file whose values override keys, reloaded when its file changes
(``refresh_profile``). Also ``SettingsDict``, the reference's name for
that base class, and ``RegParamMap``, one registration stage's
parameters.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Optional, Sequence

from magellanmapper_torch.io import yaml_io


class Profile(dict):
    """Settings dictionary with named modifier profiles.

    Attributes:
        NAME_KEY: key holding the applied profile chain name.
        DEFAULT_NAME: name of the default (unmodified) profile.
        PATH_PREFIX: filename prefix for YAML profiles of this family.
        profiles: mapping of modifier-profile name -> dict of overrides.
        timestamps: mapping of YAML path -> last-loaded mtime.
        delimiter: separator for profile chains.
    """

    NAME_KEY = "settings_name"
    DEFAULT_NAME = "default"
    PATH_PREFIX = ""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self[self.NAME_KEY] = self.DEFAULT_NAME
        self.profiles: Dict[str, dict] = {}
        self.timestamps: Dict[str, float] = {}
        self.delimiter = ","
        self.update(*args, **kwargs)

    # -- modifier application ------------------------------------------------

    def _find_profile_file(self, name: str) -> Optional[str]:
        """Resolve a profile name to a YAML file path if one exists."""
        candidates = [name]
        if self.PATH_PREFIX:
            candidates.append(f"{self.PATH_PREFIX}_{name}")
        for cand in candidates:
            for ext in ("", ".yml", ".yaml"):
                path = cand + ext
                if os.path.isfile(path):
                    return path
        return None

    def update_settings(self, mods: dict):
        """Deep-update from a modifier dict (nested dicts merge)."""
        for key, val in mods.items():
            if isinstance(val, dict) and isinstance(self.get(key), dict):
                merged = copy.deepcopy(self[key])
                _deep_update(merged, val)
                self[key] = merged
            else:
                self[key] = copy.deepcopy(val)

    def add_profiles(self, names: str):
        """Apply a comma-delimited chain of modifier profiles in order.

        Each element is looked up first among built-in ``profiles``, then as
        a YAML file path. Mirrors reference ``profiles.py:218``.
        """
        if not names:
            return
        for name in names.split(self.delimiter):
            name = name.strip()
            if not name or name == self.DEFAULT_NAME:
                continue
            if name in self.profiles:
                self.update_settings(self.profiles[name])
            else:
                path = self._find_profile_file(name)
                if path is None:
                    raise KeyError(
                        f"unknown profile '{name}' for "
                        f"{type(self).__name__}; known: "
                        f"{sorted(self.profiles)}")
                self._load_profile_file(path)
            cur = self[self.NAME_KEY]
            self[self.NAME_KEY] = (
                name if cur == self.DEFAULT_NAME
                else f"{cur}{self.delimiter}{name}")

    def _load_profile_file(self, path: str):
        data = yaml_io.load_yaml(path)
        mods: dict = {}
        for doc in data if isinstance(data, list) else [data]:
            if isinstance(doc, dict):
                _deep_update(mods, doc)
        self.update_settings(mods)
        self.timestamps[path] = os.path.getmtime(path)

    def refresh_profile(self, force: bool = False) -> bool:
        """Reload any YAML profiles whose files changed on disk.

        Returns True if any profile was reloaded (reference
        ``profiles.py:258`` reapplies the whole chain; we do the same).
        """
        stale = force
        for path, ts in self.timestamps.items():
            try:
                if os.path.getmtime(path) != ts:
                    stale = True
            except OSError:
                continue
        if stale:
            chain = self[self.NAME_KEY]
            defaults = type(self)()
            self.clear()
            self.update(defaults)
            self.profiles = defaults.profiles
            self.timestamps = {}
            if chain and chain != self.DEFAULT_NAME:
                self.add_profiles(chain)
        return stale

    def save_settings(self, path: str):
        """Persist current settings to YAML."""
        yaml_io.save_yaml(path, dict(self))


def _deep_update(base: dict, mods: dict):
    for key, val in mods.items():
        if isinstance(val, dict) and isinstance(base.get(key), dict):
            _deep_update(base[key], val)
        else:
            base[key] = val


@dataclasses.dataclass
class RegParamMap:
    """One registration stage's parameters.

    The reference's ``RegParamMap`` vocabulary (Elastix's names):
    ``map_name`` selects the transform model, ``metric_similarity`` the
    loss, ``max_iter`` the optimizer steps per resolution, and the grid
    fields the B-spline control-point spacing.
    """

    map_name: str = "affine"
    #: similarity metric; "AdvancedMattesMutualInformation" or
    #: "AdvancedNormalizedCorrelation" (reference names preserved).
    metric_similarity: str = "AdvancedMattesMutualInformation"
    max_iter: int = 256
    #: number of multi-resolution pyramid levels.
    num_resolutions: int = 4
    #: B-spline grid spacing in voxels at the finest level.
    grid_space_voxels: Optional[int] = None
    #: per-level multipliers on grid spacing (coarse->fine).
    grid_spacing_schedule: Optional[Sequence[float]] = None
    #: erode the fixed-image mask before use.
    erode_mask: bool = False
    #: include a corresponding-points (landmark) distance term.
    point_based: bool = False
    #: optimizer learning rate of the registration engine.
    learning_rate: Optional[float] = None

    def update(self, mods: dict):
        for key, val in mods.items():
            setattr(self, key, val)
        return self


class SettingsDict(Profile):
    """Reference name for the profile base class
    (``profiles.SettingsDict :37``): a dict with named-modifier deep
    merging, which :class:`Profile` implements."""

