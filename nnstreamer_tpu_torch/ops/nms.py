"""Batched non-maximum suppression on the tensor's device.

Port of ``nnstreamer_tpu/ops/nms.py``, plain PyTorch as the reference is
plain XLA (no Pallas kernel).  The keep mask equals the reference's bit
for bit: the IoU formula and its order of operations in float32 with the
``union > 0`` guard, and the candidates visited in ``jnp.argsort(-scores)``
order (stable: the lower index first among equal scores).

The reference's ``fori_loop`` over candidates is one device loop under
XLA.  Here each step is a few small launches for every frame of the batch
at once (what ``vmap`` gives the reference), with no host synchronisation
inside the loop: the IoU test is computed once, permuted into visiting
order and cut to its upper triangle, so step ``i`` only reads whether
candidate ``i`` is still unsuppressed and spreads its row.
"""

from __future__ import annotations

from typing import Any

import torch


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """boxes (..., N, 4) x1,y1,x2,y2 -> pairwise IoU (..., N, N)."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (
        boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    x1 = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    y1 = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    x2 = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    y2 = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _nms_batch(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Greedy NMS of each frame, static shapes: (B, N, 4), (B, N) -> keep
    mask (B, N) bool."""
    B, N = scores.shape
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    over = _iou_matrix(boxes) > iou_thr
    rows = order[:, :, None].expand(B, N, N)
    # over_s[b, i, j] = over[b, order[b, i], order[b, j]], for j after i only
    over_s = over.gather(1, rows).gather(2, order[:, None, :].expand(B, N, N))
    over_s &= torch.ones((N, N), dtype=torch.bool, device=over.device).triu(1)
    suppressed = torch.zeros((B, N), dtype=torch.bool, device=over.device)
    for i in range(N):
        # candidate i (in visiting order) is kept iff nothing before it
        # suppressed it; a kept candidate suppresses what it overlaps
        suppressed |= over_s[:, i] & ~suppressed[:, i:i + 1]
    keep = torch.empty_like(suppressed)
    keep.scatter_(1, order, ~suppressed)
    return keep


def batched_nms(boxes: Any, scores: Any, iou_thr: float = 0.45) -> torch.Tensor:
    """boxes (B,N,4) or (N,4), scores (B,N) or (N,) -> bool keep mask of the
    same leading shape.  Scores <= 0 are never kept (use as a validity
    mask for padded candidates)."""
    boxes = torch.as_tensor(boxes)
    scores = torch.as_tensor(scores, device=boxes.device)
    single = boxes.ndim == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    keep = _nms_batch(boxes, scores, float(iou_thr)) & (scores > 0)
    return keep[0] if single else keep
