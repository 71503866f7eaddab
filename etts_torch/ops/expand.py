"""Duration-regulated expansion at a fixed capacity (port of
``etts/ops/expand.py``): each token's vector repeats for its duration in
frames, left-packed into ``max_frames`` frames with one gather and no host
sync."""
from __future__ import annotations

import torch

__all__ = ["regulate_lengths"]


def regulate_lengths(x: torch.Tensor, durations: torch.Tensor,
                     max_frames: int):
    """Expand (b, n, d) by durations (b, n) into (b, max_frames, d).

    Durations round half to even and clamp at 0; frame t takes token
    sum(t >= cumsum) (clipped to n - 1), and frames at or past the total
    are zero (the padding frame). Returns (expanded, total lengths (b,)),
    the totals uncapped, as etts returns them."""
    dur = torch.clamp(torch.round(durations), min=0.0).to(torch.int32)
    csum = torch.cumsum(dur, 1)                              # (b, n) ends
    total = csum[:, -1]
    t = torch.arange(max_frames, device=x.device)
    src = (t[None, :, None] >= csum[:, None, :]).sum(-1)     # (b, T)
    src = torch.clamp(src, max=x.shape[1] - 1)
    out = torch.gather(x, 1, src[:, :, None].expand(-1, -1, x.shape[2]))
    valid = (t[None, :] < total[:, None]).to(x.dtype)
    return out * valid[:, :, None], total
