"""pascal-VOC-style XML annotation parsing (ImageNet VID/DET format; a
copy of the JAX package's `data/pascal.py`, which imports no JAX).

Rebuilds the `ml_utils.data.pascal` surface the reference imports
(reference data/imagenet.py:12: parse_pascal_xmlfile, PascalObjectLabel).

ImageNet VID/DET annotation files look like:

    <annotation>
      <size><width>1280</width><height>720</height></size>
      <object>
        <trackid>0</trackid>            <!-- VID only -->
        <name>n02084071</name>          <!-- wordnet id -->
        <bndbox><xmax>..</xmax><xmin>..</xmin>
                <ymax>..</ymax><ymin>..</ymin></bndbox>
      </object>
      ...
    </annotation>

Boxes are returned as FRACTIONAL ijhw (center-row, center-col, height,
width), the convention used throughout the framework.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from os import PathLike
from typing import NamedTuple, Optional, Tuple


class PascalObjectLabel(NamedTuple):
    class_id: str  # wordnet id (e.g. "n02084071")
    bbox: Tuple[float, float, float, float]  # fractional ijhw
    track_id: Optional[int] = None


def parse_pascal_xmlfile(labelpath: PathLike) -> Tuple[PascalObjectLabel, ...]:
    """parse one annotation file into PascalObjectLabel tuples."""
    root = ET.parse(str(labelpath)).getroot()

    size = root.find("size")
    im_w = float(size.find("width").text)
    im_h = float(size.find("height").text)

    labels = []
    for obj in root.iter("object"):
        name = obj.find("name").text.strip()
        tid_node = obj.find("trackid")
        track_id = int(tid_node.text) if tid_node is not None else None

        bb = obj.find("bndbox")
        xmin = float(bb.find("xmin").text)
        xmax = float(bb.find("xmax").text)
        ymin = float(bb.find("ymin").text)
        ymax = float(bb.find("ymax").text)

        ci = (ymin + ymax) / 2 / im_h
        cj = (xmin + xmax) / 2 / im_w
        h = (ymax - ymin) / im_h
        w = (xmax - xmin) / im_w
        if h <= 0 or w <= 0:
            # real ILSVRC annotations occasionally carry degenerate boxes
            # (xmax == xmin): a zero-size gt can only produce a nonsense
            # regression target -- its is-best anchor becomes a weight-1
            # positive trained toward log(~0/a_hw) ~ -17 -- so drop it
            # here, before it can become a target. frcnn_box_encode's hw
            # floor stays as defense-in-depth for padding slots and
            # non-pascal label sources.
            continue
        labels.append(
            PascalObjectLabel(class_id=name, bbox=(ci, cj, h, w), track_id=track_id)
        )
    return tuple(labels)
