"""visualization utilities (a copy of the JAX package's `vis.py`: the
ml_utils.vis_utils surface, draw_detections, used by the reference's report
step at trainer.py:335-336)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


def draw_detections(
    im: Image.Image,
    boxes: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    color: str = "red",
) -> Image.Image:
    """draw fractional ijhw boxes (+ optional labels) onto a PIL image
    IN PLACE; returns the image for chaining."""
    if len(boxes) == 0:
        return im
    draw = ImageDraw.Draw(im)
    w, h = im.size
    for n, box in enumerate(np.asarray(boxes)):
        ci, cj, bh, bw = (float(v) for v in box)
        x0 = (cj - bw / 2) * w
        x1 = (cj + bw / 2) * w
        y0 = (ci - bh / 2) * h
        y1 = (ci + bh / 2) * h
        draw.rectangle([x0, y0, x1, y1], outline=color, width=2)
        if labels is not None and n < len(labels):
            draw.text((x0 + 2, y0 + 2), str(labels[n]), fill=color)
    return im
