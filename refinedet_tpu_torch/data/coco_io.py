"""Minimal pure-Python COCO annotation API.

Port of ``refinedet_tpu/data/coco_io.py``: the subset of pycocotools'
``COCO`` object the datasets need (index construction, ann/img/cat
lookups, loadRes) as plain dict/list operations over the COCO json
schema, so pycocotools is not required.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List, Optional, Union


class COCO:
    """COCO annotation container with pycocotools-compatible accessors."""

    def __init__(self, annotation_file: Union[str, dict, None] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.create_index()

    def create_index(self) -> None:
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    # -- pycocotools-style accessors ---------------------------------------
    def getImgIds(self, imgIds=(), catIds=()) -> List[int]:
        if not imgIds and not catIds:
            return sorted(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for cat in catIds:
            ids &= set(self.cat_to_imgs[cat])
        return sorted(ids)

    def getCatIds(self, catNms=(), supNms=(), catIds=()) -> List[int]:
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return sorted(c["id"] for c in cats)

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(),
                  iscrowd: Optional[bool] = None) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        if isinstance(catIds, int):
            catIds = [catIds]
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns
                    if bool(a.get("iscrowd", 0)) == bool(iscrowd)]
        return [a["id"] for a in anns]

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadRes(self, res: Union[str, List[dict]]) -> "COCO":
        """Build a detection-result COCO sharing this object's images."""
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        out = COCO()
        out.dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
            "annotations": [],
        }
        anns = copy.deepcopy(res)
        for i, ann in enumerate(anns):
            x, y, w, h = ann["bbox"]
            ann.setdefault("area", w * h)
            ann["id"] = i + 1
            ann.setdefault("iscrowd", 0)
        out.dataset["annotations"] = anns
        out.create_index()
        return out
