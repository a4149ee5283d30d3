"""Instance attention keep-mask for the gated self-attention (fuser)
(counterpart of `instancediffusion_tpu/ops/instance_mask.py`).

Over the fuser's sequence [S*S visual tokens | 4*n_objs grounding tokens |
seg tokens], at the ds1 resolution only:

  * visual <-> visual: kept iff the two tokens share an instance; the
    diagonal is always kept
  * box and polygon grounding rows attend only their instance's pixels;
    point and scribble rows attend everything
  * visual -> grounding is the transpose; grounding <-> grounding and every
    seg row and column are unrestricted
  * a sample with all-zero masks (the CFG null half) or `drop_box_mask` is
    not masked at all

`build_fuser_mask` gives the dense (B,1,N,N) bool form; the flash kernel
takes the same predicate as per-token labels
(`kernels.flash_attention.instance_labels`).
"""

from __future__ import annotations

import torch


def rasterize_boxes(boxes01: torch.Tensor, image_size: int = 64) -> torch.Tensor:
    """(.., n, 4) xyxy in [0,1] -> (.., n, S, S) float32 binary box masks.

    Rounded pixel bounds (torch.round, like jnp.round, rounds half to even),
    ROWS indexed by x and COLS by y: the reference's
    att_masks[idx][x1:x2, y1:y2] = 1 quirk, kept for checkpoint
    compatibility."""
    s = image_size
    px = torch.round(boxes01.float() * s).to(torch.int32)
    x1, y1, x2, y2 = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    r = torch.arange(s, device=boxes01.device)
    row_in = (r >= x1[..., None]) & (r < x2[..., None])   # (.., n, S)
    col_in = (r >= y1[..., None]) & (r < y2[..., None])
    return (row_in[..., :, None] & col_in[..., None, :]).float()
