"""data layer (numpy, no torch): the label and instance types, the padded
batch types and `pack_labels` (data/types.py), and the synthetic frame-pair
dataset (data/synthetic.py). A copy of the JAX package's `data/` types, so
the port imports nothing of that package."""

from .types import DataManager, ImageInstance, ObjectLabel, PaddedFrame, PaddedPairBatch, pack_labels
