"""the port's ops: the plain PyTorch versions (`torch_ref`), the pooling and
proposal filter (plain PyTorch, as the JAX package left them to XLA) and
the correlation, whose forward is a hand-written CUDA kernel
(`csrc/corr_fwd.cu`)."""

from .correlation import corr_fwd_cuda, pointwise_correlation
from .nms import Proposals, batched_proposal_filter, nms_mask, proposal_filter, top_k_proposals
from .pooling import ps_roi_pool, roi_pool, roi_pool_linear
from .torch_ref import pointwise_correlation_ref, ps_roi_pool_ref, roi_pool_ref
