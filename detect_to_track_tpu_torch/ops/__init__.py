"""the port's ops: the plain PyTorch versions (`torch_ref`), the pooling
(whose einsum forms run on the card as the ops `d2t::psroi_fwd` /
`d2t::psroi_bwd`, PSROIPool's hand-written CUDA kernels `csrc/psroi.cu`, and
`d2t::roipool_linear_fwd` / `_bwd` and `d2t::roipool_fwd` / `_bwd`,
ROIPool's `csrc/roipool.cu`; their sat forms are plain PyTorch), the proposal filter
around the greedy NMS (the op `d2t::nms_mask`, the hand-written CUDA
kernel `csrc/nms.cu` on the card) and the correlation, whose kernels
(`csrc/corr_fwd.cu`, `csrc/corr_bwd.cu`) are the ops `d2t::corr_fwd`,
`d2t::corr_bwd_fm0` and `d2t::corr_bwd_fm1`. Importing this package
registers the ops, which an exported program (`export.py`) calls."""

from .correlation import corr_fwd_cuda, pointwise_correlation
from .nms import Proposals, batched_proposal_filter, nms_mask, nms_mask_ref, proposal_filter, top_k_proposals
from .pooling import (ps_roi_pool, psroi_bwd_cuda, psroi_fwd_cuda, roi_pool, roi_pool_linear, roipool_bwd_cuda,
                      roipool_fwd_cuda, roipool_linear_bwd_cuda, roipool_linear_fwd_cuda)
from .torch_ref import pointwise_correlation_ref, ps_roi_pool_ref, roi_pool_ref
