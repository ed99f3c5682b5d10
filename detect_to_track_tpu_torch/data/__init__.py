"""data layer (numpy and PIL, no torch): the label, instance and sampler
types, the padded batch types and `pack_labels` (data/types.py), pascal-VOC
annotation parsing (data/pascal.py), the sampling helpers
(data/sampling.py), the ImageNet VID / DET samplers and managers
(data/imagenet.py) and the synthetic frame-pair dataset (data/synthetic.py).
Copies of the JAX package's `data/` modules, so the port imports nothing of
that package."""

from .types import (
    DataManager,
    DataManagerWrapper,
    DataSampler,
    ImageInstance,
    ObjectLabel,
    PaddedFrame,
    PaddedPairBatch,
    RawImageInstance,
    pack_labels,
)
