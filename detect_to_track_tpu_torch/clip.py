"""full-clip inference: per-frame shared-backbone detection + Viterbi tubelet
linking (port of the JAX package's `clip.py`).

A clip runs through `Detector.detect_clip` in fixed-size chunks with a
one-frame overlap: the backbone, RPN and R-FCN run once per frame, the
tracker covers every adjacent pair by slicing the shared feature batch, and
tubelets come out of the Viterbi linker.

Two linker paths:
- device (default): link scoring and the multi-path extraction run on the
  detector's device (viterbi_device.py; on the card one launch of the linker
  kernel, ops/csrc/viterbi.cu). Between chunks only the (D, D) link-score
  matrices stay on the device; the host sees the boxes and the final integer
  paths.
- host: per-frame detections are copied to the host and the native C++
  linker runs (viterbi.py) -- the oracle path.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .encoding import frcnn_box_decode
from .inference import ClipDetections, Detector
from .utils import promote_mixed_image_dtypes
from .viterbi import viterbi_tracking
from .viterbi_device import clip_link_scores, viterbi_multi_link_scan

Tubelets = List[Tuple[Tuple[int, int], np.ndarray]]


class ClipTracker:
    """detect + track over a whole clip.

    Args:
        detector: a Detector; the clip runs on its device.
        link_iou_thresh: IoU threshold for track-link scoring psi.
        min_len: minimum tubelet length to keep.
        frame_chunk: frames per detect_clip call (clips longer than this are
            processed in overlapping chunks).
        pair_batch: the older unit of frame_chunk, in adjacent PAIRS per
            call: frame_chunk = pair_batch + 1.
        device_linking: run link scoring + the Viterbi extraction on the
            device (viterbi_device.py); False copies detections to the host
            and runs the native linker.
        uint8_upload: ship frames to the device as uint8 and divide by 255
            there -- 4x less transfer than float32 (exact for PIL/uint8
            sources, <= 1/510 quantization for float input).
    """

    def __init__(
        self,
        detector: Detector,
        link_iou_thresh: float = 0.5,
        min_len: int = 2,
        frame_chunk: int = 8,
        pair_batch: Optional[int] = None,
        device_linking: bool = True,
        uint8_upload: bool = True,
    ) -> None:
        self.detector = detector
        self.link_iou_thresh = link_iou_thresh
        self.min_len = min_len
        # a chunk of F consecutive frames holds F-1 adjacent pairs, so the
        # pair unit means frame_chunk = pair_batch + 1
        self.frame_chunk = max(pair_batch + 1 if pair_batch else frame_chunk, 2)
        self.device_linking = device_linking
        self.uint8_upload = uint8_upload
        self.last_upload_s = 0.0  # host time spent issuing uploads, last call

    # -- device path ------------------------------------------------------

    def _chunk_scores(self, out: ClipDetections) -> Tuple[torch.Tensor, torch.Tensor]:
        """ClipDetections -> ((F-1, D, D) link scores, (D,) frame-0 init
        scores), on the detections' device."""
        with record_function("d2t::link_scores"):
            confs = out.confs[:, :, 1:].sum(-1)  # (F, D) class-summed
            track_boxes = frcnn_box_decode(out.boxes[:-1], out.tracks)
            return clip_link_scores(confs, out.boxes, track_boxes, out.valid, self.link_iou_thresh)

    def _link_device(self, seq_slots, init: torch.Tensor, bbox_host: List[np.ndarray]) -> Tubelets:
        with record_function("d2t::linker"):
            out = viterbi_multi_link_scan(torch.stack(seq_slots), init)
        n = int(out.n_paths)
        spans = out.spans[:n].cpu().numpy()
        nodes = out.nodes[:n].cpu().numpy()
        tubelets = []
        for (s, e), path in zip(spans.tolist(), nodes):
            if e - s + 1 < self.min_len:
                continue
            tubelets.append(((s, e), np.array([bbox_host[ts][path[ts]] for ts in range(s, e + 1)])))
        return tubelets

    # -- shared chunking loop ---------------------------------------------

    def __call__(self, frames: Sequence) -> Tubelets:
        """frames: sequence of PIL images or (H, W, 3) arrays, uint8 or
        float in [0, 1].

        Returns tubelets [((start_ts, end_ts), boxes (len, 4))].
        """
        if len(frames) < 2:
            raise ValueError("need at least 2 frames")
        det = self.detector
        arrs = [det._to_array(f) for f in frames]
        if self.uint8_upload:
            # _to_array returns PIL/uint8 sources as uint8 already: only
            # float [0, 1] arrays are rescaled
            arrs = [
                a if a.dtype == np.uint8 else np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8) for a in arrs
            ]
        else:
            arrs = promote_mixed_image_dtypes(arrs)
        n = len(arrs)
        chunk = min(self.frame_chunk, n)

        bbox_seq: List[Optional[np.ndarray]] = [None] * n
        seq_slots: List[Optional[torch.Tensor]] = [None] * (n - 1)  # device (D, D) link scores
        chunk_boxes = []  # (chunk start, device (F, D, 4)) per chunk
        init_scores = None
        conf_seq: List[Optional[np.ndarray]] = [None] * n
        track_seq: List[Optional[np.ndarray]] = [None] * (n - 1)

        # overlapping chunks: each covers frames [s, s+chunk); consecutive
        # chunks share one frame so every adjacent pair gets a track. The
        # final chunk is aligned to end exactly at the last frame.
        starts = list(range(0, n - chunk, chunk - 1)) + [n - chunk]

        dev = det.device
        self.last_upload_s = 0.0

        def upload(s):
            # the next chunk's frames go in as a non-blocking copy from
            # pinned memory while the current chunk is enqueued
            t0 = time.perf_counter()
            host = torch.from_numpy(np.stack(arrs[s : s + chunk]))
            buf = host.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else host.to(dev)
            self.last_upload_s += time.perf_counter() - t0
            return buf

        with torch.inference_mode():
            pending = upload(starts[0])
            for si, s in enumerate(starts):
                window = pending
                if si + 1 < len(starts):
                    pending = upload(starts[si + 1])
                out = det.detect_clip(window)

                if self.device_linking:
                    seq, init = self._chunk_scores(out)
                    if s == 0:
                        init_scores = init
                    for fi in range(chunk - 1):
                        if seq_slots[s + fi] is None:
                            seq_slots[s + fi] = seq[fi]
                    # boxes stay on the device until every chunk is enqueued
                    chunk_boxes.append((s, out.boxes))
                    continue

                confs = out.confs.cpu().numpy()  # (F, D, C+1)
                boxes = out.boxes.cpu().numpy()
                valid = out.valid.cpu().numpy()
                # predicted frame-(t+1) positions of frame-t detections
                tracks = frcnn_box_decode(out.boxes[:-1], out.tracks).cpu().numpy()  # (F-1, D, 4)
                for fi in range(chunk):
                    t = s + fi
                    v = valid[fi]
                    if conf_seq[t] is None:
                        conf_seq[t] = confs[fi][v][:, 1:].sum(-1)
                        bbox_seq[t] = boxes[fi][v]
                    if fi < chunk - 1 and track_seq[t] is None:
                        track_seq[t] = tracks[fi][v].reshape(-1, 4)

            if self.device_linking:
                # one copy to the host for all chunks' boxes (F x D x 4 each)
                got = torch.stack([b for _, b in chunk_boxes]).cpu().numpy()
                for (cs, _), boxes in zip(chunk_boxes, got):
                    for fi in range(chunk):
                        if bbox_seq[cs + fi] is None:
                            bbox_seq[cs + fi] = boxes[fi]
                return self._link_device(seq_slots, init_scores, bbox_seq)

        return viterbi_tracking(conf_seq, bbox_seq, track_seq, self.link_iou_thresh, self.min_len)
