"""Labels metadata sidecar.

Copy of ``magellanmapper_tpu/atlas/labels_meta.py``: persists labels
provenance next to a labels image (the ontology reference path and the
original region IDs) as a YAML file named ``<prefix>_meta_labels.yml``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from magellanmapper_torch.io import yaml_io

SUFFIX = "meta_labels.yml"


class LabelsMeta:
    """Labels metadata: reference path + original region IDs."""

    def __init__(self, prefix: Optional[str] = None):
        self.prefix = prefix
        self.path_ref: Optional[str] = None
        self.region_ids_orig: Optional[Sequence[int]] = None

    @property
    def save_path(self) -> str:
        base = os.path.splitext(self.prefix)[0] if self.prefix else "labels"
        return f"{base}_{SUFFIX}"

    def save(self) -> str:
        yaml_io.save_yaml(self.save_path, {
            "path_ref": self.path_ref,
            "region_ids_orig": (
                list(int(i) for i in self.region_ids_orig)
                if self.region_ids_orig is not None else None),
        })
        return self.save_path

    def load(self) -> "LabelsMeta":
        if os.path.exists(self.save_path):
            docs = yaml_io.load_yaml(self.save_path)
            meta = docs[0] if docs else {}
            self.path_ref = meta.get("path_ref")
            self.region_ids_orig = meta.get("region_ids_orig")
        return self
