"""Application preferences profile.

Copy of ``magellanmapper_tpu/settings/prefs_prof.py``: the preference
keys the headless workflows use, persisted to ``prefs.yaml``.
"""

from __future__ import annotations

import os

from magellanmapper_torch.io import yaml_io
from magellanmapper_torch.settings.profiles import Profile

PREFS_FILE = "prefs.yaml"


class PrefsProfile(Profile):
    """User preferences with YAML persistence."""

    PATH_PREFIX = "prefs"

    def __init__(self, *args, **kwargs):
        super().__init__()
        self["fig_save_dir"] = ""
        self["roi_circles"] = "Circles"
        self["roi_plane"] = "xy"
        self["roi_styles"] = ""
        self["theme"] = "default"
        self["verified"] = False
        self["max_scroll"] = 20
        self.update(*args, **kwargs)
        self.profiles = {}

    def save_prefs(self, path: str = PREFS_FILE) -> str:
        yaml_io.save_yaml(path, {
            k: v for k, v in self.items() if k != "profiles"})
        return path

    def load_prefs(self, path: str = PREFS_FILE) -> "PrefsProfile":
        if os.path.exists(path):
            docs = yaml_io.load_yaml(path)
            if docs:
                self.update(docs[0])
        return self
