"""synthetic frame-pair dataset (numpy; a copy of the JAX package's
`data/synthetic.py`): coloured rectangles drifting across a noisy
background, with exact box, class and track labels. The tests and the chip
smoke run train on it."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .types import DataManager, ImageInstance, ObjectLabel


class SyntheticVIDManager(DataManager):
    """deterministic synthetic video-pair dataset.

    Item i is a frame pair (t, t+1) of n_objects rectangles with
    per-object velocity; labels carry stable (class_id, track_id) pairs, so
    track encoding has real cross-frame matches. Images are (H, W, 3)
    float32 arrays in [0, 1].
    """

    def __init__(
        self,
        n_samples: int = 16,
        image_hw: Tuple[int, int] = (64, 96),
        n_objects: int = 3,
        n_classes: int = 30,
        seed: int = 0,
    ) -> None:
        self.n_samples = n_samples
        self.image_hw = image_hw
        self.n_objects = n_objects
        self.n_classes = n_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, i: int) -> Tuple[ImageInstance, ImageInstance]:
        rng = np.random.RandomState(self.seed * 100003 + i)
        h, w = self.image_hw

        centers = rng.rand(self.n_objects, 2) * 0.6 + 0.2  # (i, j)
        sizes = rng.rand(self.n_objects, 2) * 0.2 + 0.1  # (h, w)
        vel = (rng.rand(self.n_objects, 2) - 0.5) * 0.1
        classes = rng.randint(1, self.n_classes + 1, self.n_objects)
        colors = rng.rand(self.n_objects, 3) * 0.8 + 0.2

        def render(t: int) -> ImageInstance:
            im = rng.rand(h, w, 3).astype(np.float32) * 0.1
            labels = []
            for o in range(self.n_objects):
                ci, cj = centers[o] + t * vel[o]
                oh, ow = sizes[o]
                i0 = int(np.clip((ci - oh / 2) * h, 0, h - 1))
                i1 = int(np.clip((ci + oh / 2) * h, 1, h))
                j0 = int(np.clip((cj - ow / 2) * w, 0, w - 1))
                j1 = int(np.clip((cj + ow / 2) * w, 1, w))
                im[i0:i1, j0:j1] = colors[o]
                labels.append(
                    ObjectLabel(
                        class_id=int(classes[o]),
                        class_name=f"class_{classes[o]}",
                        box=(float(ci), float(cj), float(oh), float(ow)),
                        track_id=o,
                    )
                )
            return ImageInstance(im=im, labels=tuple(labels))

        return render(0), render(1)
