"""Label ontology: ABA-style hierarchies, lookups, level remapping.

Copy of ``magellanmapper_tpu/atlas/ontology.py`` (host code: numpy,
pandas and json), with its behaviour and file formats: ``LabelsRef``
(Allen JSON, CSV and ITK-SNAP ``.txt``), the reverse lookup with mirrored
negative IDs, ``make_labels_level``, ``scale_coords`` (float64 products
truncated with ``astype(int)``, as in the reference) and
``get_label_ids_from_position``. Negative label IDs denote the mirrored
(contralateral) hemisphere.
"""

from __future__ import annotations

import json
import os
from enum import Enum
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

#: ABA JSON keys
ABA_ID = "id"
ABA_NAME = "name"
ABA_ACRONYM = "acronym"
ABA_CHILDREN = "children"
ABA_PARENT = "parent_structure_id"
ABA_LEVEL = "st_level"
#: augmented keys in the reverse lookup
NODE = "node"
PARENT_IDS = "parent_ids"
MIRRORED = "mirrored"

RIGHT_SUFFIX = " (R)"
LEFT_SUFFIX = " (L)"


class LabelsRef:
    """Labels reference container (reference ``ontology.LabelsRef``)."""

    def __init__(self, path_ref: Optional[str] = None):
        self.path_ref = path_ref
        self.loaded_ref = None
        self.ref_lookup: Optional[Dict[int, Dict]] = None

    def load_labels_ref(self, path: Optional[str] = None):
        """Load an ABA JSON or CSV reference."""
        if not path:
            path = self.path_ref
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                f"Could not load labels reference file from '{path}'")
        ext = os.path.splitext(path)[1]
        if ext == ".json":
            with open(path) as f:
                self.loaded_ref = json.load(f)
        elif ext == ".txt":
            # ITK-SNAP label description file
            self.loaded_ref = convert_itksnap_to_df(path)
        else:
            df = pd.read_csv(path)
            self.loaded_ref = df.rename(
                {"Region": ABA_ID, "RegionName": ABA_NAME}, axis=1)
        return self.loaded_ref

    def create_ref_lookup(self, mirror: bool = True) -> Dict[int, Dict]:
        """Build the id -> node reverse lookup with parent chains;
        optionally add mirrored negative IDs."""
        lookup: Dict[int, Dict] = {}
        if isinstance(self.loaded_ref, pd.DataFrame):
            for _, row in self.loaded_ref.iterrows():
                node = {k: row[k] for k in self.loaded_ref.columns}
                lid = int(row[ABA_ID])
                lookup[lid] = {
                    NODE: node, PARENT_IDS: [], MIRRORED: False}
        else:
            root = self.loaded_ref
            if isinstance(root, dict) and "msg" in root:
                roots = root["msg"]
            elif isinstance(root, list):
                roots = root
            else:
                roots = [root]

            def walk(node, parents):
                lid = int(node[ABA_ID])
                lookup[lid] = {
                    NODE: node, PARENT_IDS: list(parents), MIRRORED: False}
                for child in node.get(ABA_CHILDREN, []) or []:
                    walk(child, parents + [lid])

            for r in roots:
                walk(r, [])
        if mirror:
            for lid in list(lookup.keys()):
                if lid == 0:
                    continue
                entry = lookup[lid]
                lookup[-lid] = {
                    NODE: entry[NODE],
                    PARENT_IDS: [-p for p in entry[PARENT_IDS]],
                    MIRRORED: True,
                }
        self.ref_lookup = lookup
        return lookup

    def load(self) -> "LabelsRef":
        self.load_labels_ref()
        self.create_ref_lookup()
        return self

    def get_ref_lookup_as_df(self) -> Optional[pd.DataFrame]:
        """Flatten the lookup into a Region/RegionName/Level/Parent frame."""
        if self.ref_lookup is None:
            return None
        rows = []
        for lid, entry in self.ref_lookup.items():
            node = entry[NODE]
            rows.append({
                "Region": lid,
                "RegionName": get_label_name(entry),
                "Level": node.get(ABA_LEVEL),
                "Acronym": node.get(ABA_ACRONYM),
                "ParentIDs": entry[PARENT_IDS],
            })
        return pd.DataFrame(rows)


def get_label_name(
        label: Optional[Dict], side: bool = False) -> Optional[str]:
    """Name of a lookup entry, with optional hemisphere suffix
    (reference ``ontology.get_label_name :643``)."""
    if label is None:
        return None
    name = label[NODE].get(ABA_NAME)
    if side and name is not None:
        name += LEFT_SUFFIX if label.get(MIRRORED) else RIGHT_SUFFIX
    return name


def get_label_side(label_id: Union[int, Sequence[int]]) -> str:
    """Hemisphere of an ID or ID set (reference ``get_label_side :679``)."""
    ids = np.atleast_1d(label_id)
    if np.all(ids >= 0):
        return RIGHT_SUFFIX
    if np.all(ids < 0):
        return LEFT_SUFFIX
    return ""


def get_children_from_id(
        lookup: Dict[int, Dict], label_id: int,
        incl_parent: bool = True, both_sides: bool = False) -> List[int]:
    """All descendant IDs of a label (reference ``:432``)."""
    out = []
    sign = -1 if label_id < 0 else 1

    entry = lookup.get(label_id)
    if entry is None:
        return out

    def walk(node):
        lid = sign * int(node[ABA_ID])
        out.append(lid)
        for child in node.get(ABA_CHILDREN, []) or []:
            walk(child)

    walk(entry[NODE])
    if not incl_parent:
        out = out[1:]
    if both_sides:
        out = out + [-i for i in out]
    return out


def labels_to_parent(
        lookup: Dict[int, Dict], level: Optional[int] = None,
        allow_parent_same_level: bool = True) -> Dict[int, int]:
    """Map each label ID to its ancestor at ``level``
    (reference ``:504``)."""
    out = {}
    for lid, entry in lookup.items():
        parent = lid
        if level is not None:
            node_level = entry[NODE].get(ABA_LEVEL)
            if node_level is not None and node_level > level:
                for pid in entry[PARENT_IDS]:
                    p_entry = lookup.get(pid)
                    if p_entry is None:
                        continue
                    p_level = p_entry[NODE].get(ABA_LEVEL)
                    if p_level is not None and p_level == level:
                        parent = pid
                        break
        out[lid] = parent
    return out


def make_labels_level(
        labels_img: np.ndarray, lookup: Dict[int, Dict],
        level: int) -> np.ndarray:
    """Remap a labels image so every label collapses to its ``level``
    ancestor (reference ``make_labels_level :577``)."""
    mapping = labels_to_parent(lookup, level)
    ids = np.unique(labels_img)
    out = np.array(labels_img)
    for lid in ids:
        if lid == 0:
            continue
        target = mapping.get(int(lid), int(lid))
        if target != lid:
            out[labels_img == lid] = target
    return out


def scale_coords(
        coords: np.ndarray, scaling: Sequence[float],
        clip_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """Scale z,y,x coordinates into another image's space
    (reference ``scale_coords :703``)."""
    scaled = np.multiply(coords[:, :3], scaling)
    scaled = scaled.astype(int)
    if clip_shape is not None:
        scaled = np.clip(scaled, 0, np.subtract(clip_shape, 1))
    return scaled


def get_label_ids_from_position(
        coords_scaled: np.ndarray, labels_img: np.ndarray) -> np.ndarray:
    """Label ID under each scaled coordinate (reference ``:758``)."""
    return labels_img[tuple(coords_scaled[:, :3].T)]


def replace_labels(
        labels_img: np.ndarray, df: pd.DataFrame,
        clear: bool = False) -> np.ndarray:
    """Replace label IDs per a ``Region``->``RegionTo`` frame
    (reference ``replace_labels :979``)."""
    out = np.array(labels_img)
    if clear:
        out[:] = 0
    for _, row in df.iterrows():
        out[labels_img == row["Region"]] = row["RegionTo"]
    return out


def convert_itksnap_to_df(path: str) -> pd.DataFrame:
    """Parse an ITK-SNAP label description file into a Region frame
    (reference ``ontology.convert_itksnap_to_df :347``).

    Format per line: ``IDX R G B A VIS MSH "LABEL"``.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split('"')
            name = parts[1] if len(parts) > 1 else ""
            nums = parts[0].split()
            if not nums:
                continue
            rows.append({
                ABA_ID: int(nums[0]),
                ABA_NAME: name,
                "R": int(nums[1]) if len(nums) > 1 else 0,
                "G": int(nums[2]) if len(nums) > 2 else 0,
                "B": int(nums[3]) if len(nums) > 3 else 0,
            })
    return pd.DataFrame(rows)


def get_label_item(label: Optional[Dict], item_key: str, key: str = NODE):
    """Item from a label's nested node dict, or None
    (reference ``ontology.get_label_item :620``)."""
    try:
        if label is not None and label.get(key) is not None:
            return label[key].get(item_key)
    except (KeyError, AttributeError, TypeError):
        pass
    return None


def get_label_at_level(
        label_id: Union[int, Sequence[int]], labels_lookup: Dict[int, Dict],
        level: Optional[int] = None) -> Optional[Dict]:
    """Label entry, collapsed to its ``level`` ancestor when given
    (reference ``ontology.get_label_at_level :810``)."""
    ids = np.atleast_1d(label_id)
    if not len(ids):
        return None
    lid = int(ids[0])
    label = labels_lookup.get(lid)
    if label is None or level is None:
        return label
    node_level = label[NODE].get(ABA_LEVEL)
    if node_level is not None and node_level > level:
        sign = -1 if lid < 0 else 1
        for pid in label[PARENT_IDS]:
            parent = labels_lookup.get(pid)
            if parent is not None and \
                    parent[NODE].get(ABA_LEVEL) == level:
                # keep the queried hemisphere
                return labels_lookup.get(sign * abs(pid), parent)
    return label


def get_label(
        coord: Sequence[int], labels_img: np.ndarray,
        labels_lookup: Dict[int, Dict],
        scaling: Optional[Sequence[float]] = None,
        level: Optional[int] = None,
        rounding: bool = False) -> Optional[Dict]:
    """Atlas label under a z,y,x coordinate
    (reference ``ontology.get_label :779``)."""
    coord = np.asarray(coord, float)[:3]
    if scaling is not None:
        coord = coord * np.asarray(scaling, float)
    coord = np.round(coord).astype(int) if rounding else coord.astype(int)
    coord = np.clip(coord, 0, np.subtract(labels_img.shape[:3], 1))
    lid = int(labels_img[tuple(coord)])
    return get_label_at_level(lid, labels_lookup, level)


def get_children_from_id_df(
        df, label_id, label_col: str = "Region",
        parent_col: str = "Parent", incl_parent: bool = True,
        ids: Optional[List[int]] = None) -> List[int]:
    """Descendants of an ID per a Region/Parent data frame
    (reference ``ontology.get_children_from_id_df :460``)."""
    if ids is None:
        ids = list(np.atleast_1d(label_id)) if incl_parent else []
    children = df.loc[
        df[parent_col].isin(np.atleast_1d(label_id)), label_col].tolist()
    if children:
        ids.extend(children)
        get_children_from_id_df(
            df, children, label_col, parent_col, incl_parent, ids)
    return ids


def get_region_middle(
        labels_ref_lookup: Dict[int, Dict], label_id,
        labels_img: np.ndarray,
        scaling: Optional[Sequence[float]] = None,
        both_sides=False, incl_children: bool = True):
    """Median coordinate of a region (guaranteed inside the region),
    its mask, and the scaled coordinate
    (reference ``ontology.get_region_middle :862``)."""
    ids: List[int] = []
    sides = np.broadcast_to(
        np.atleast_1d(both_sides), np.atleast_1d(label_id).shape)
    for lid, both in zip(np.atleast_1d(label_id), sides):
        if incl_children:
            ids.extend(get_children_from_id(
                labels_ref_lookup, int(lid), both_sides=bool(both)))
        else:
            ids.append(int(lid))
            if both:
                ids.append(-int(lid))
    mask = np.isin(labels_img, ids)
    coords = np.argwhere(mask)
    if not len(coords):
        return None, None, None
    order = np.lexsort(coords.T[::-1])
    mid = coords[order[len(order) // 2]]
    coord_scaled = mid if scaling is None else np.around(
        np.divide(mid, scaling)).astype(int)
    return tuple(int(c) for c in mid), mask, tuple(
        int(c) for c in coord_scaled)


def rel_to_abs_ages(rel_ages: Sequence[str],
                    gestation: float = 19) -> Dict[str, float]:
    """``E``/``P`` stage names to absolute ages in days
    (reference ``ontology.rel_to_abs_ages :955``)."""
    ages = {}
    for val in rel_ages:
        age = float(val[1:])
        if val[0].lower() == "p":
            age += float(gestation)
        ages[val] = age
    return ages


class LabelColumns(Enum):
    """Label translation frame columns
    (reference ``ontology.LabelColumns :28``)."""
    FROM_LABEL = "FromLabel"
    TO_LABEL = "ToLabel"
