"""PyTorch model components (NHWC at every public function), mirroring the
JAX package's `models/`."""

from .correlation_tracker import CorrelationTracker
from .detect_track import DetectTrackModule
from .resnet import ResNetBackbone
from .rfcn import RFCN
from .rpn import RPN
