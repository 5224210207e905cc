"""iNaturalist from its annotation JSONs, the port's own copy of the JAX
package's ``data/inat.py`` (the reference's ``INatDataset``):

  * ``{train|val}{year}.json`` list the images, ``categories.json`` the
    taxonomy; class indices follow the FIRST APPEARANCE of the chosen
    taxonomic level (``category``) in the train annotations, as the
    reference's ``targeter`` assigns them;
  * an image's path is ``root/<part 0>/<category id>/<file name>``.

It has ImageFolder's ``samples`` contract, so ``iterate_batches`` takes it
(the native JPEG path included).
"""

from __future__ import annotations

import json
import os


class INatDataset:
    def __init__(self, root: str, train: bool = True, year: int = 2018,
                 category: str = "name"):
        split = "train" if train else "val"
        with open(os.path.join(root, f"{split}{year}.json")) as f:
            data = json.load(f)
        with open(os.path.join(root, "categories.json")) as f:
            categories = json.load(f)
        with open(os.path.join(root, f"train{year}.json")) as f:
            train_data = json.load(f)
        targeter: dict = {}
        for ann in train_data["annotations"]:
            key = categories[int(ann["category_id"])][category]
            if key not in targeter:
                targeter[key] = len(targeter)
        self.num_classes = len(targeter)
        self.samples: list[tuple[str, int]] = []
        for img in data["images"]:
            parts = img["file_name"].split("/")
            category_id = int(parts[2])
            self.samples.append((
                os.path.join(root, parts[0], parts[2], parts[3]),
                targeter[categories[category_id][category]]))
        if not self.samples:
            raise FileNotFoundError(f"no images listed in {split}{year}.json")

    def __len__(self) -> int:
        return len(self.samples)
