"""CenterNet ground-truth targets, rendered on the model's device.

Counterpart of the JAX package's ``ops/target_gen.py`` (the reference's
per-object ``gen_heatmap`` loop, vectorized over a fixed-capacity object
tensor): every object renders its gaussian against the whole output map by
broadcasting, and the per-class composition is a max. Matched exactly:

  * ``gaussian_radius``: the three-case min-overlap-0.7 quadratic on
    ceil(h), ceil(w), with the reference's "/2 on all three roots" quirk,
    truncated toward zero and floored at 0;
  * sigma = (2r + 1) / 6, the stamp clipped to ``|dx| <= r, |dy| <= r``;
  * centers quantized with int() truncation;
  * wh in output-map units, reg = ct - ct_int, ind = y * W + x.

The per-class max is a ``scatter_reduce("amax")`` into a zero map, the JAX
``segment_max`` clamped at 0: the same, since every gaussian is >= 0.
"""

from typing import Dict

import torch

_F32 = torch.float32


def gaussian_radius(height: torch.Tensor, width: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    """Gaussian radius per box (un-truncated floats) from box sizes in
    output-map pixels (ceil'ed by the caller)."""
    h, w = height, width
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2
    # the reference divides ALL three roots by 2, not by 2a: an upstream
    # CenterNet quirk, kept for target parity
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def gen_centernet_targets(
    boxes: torch.Tensor,  # (N, M, 4) XYXY in input pixels
    classes: torch.Tensor,  # (N, M) int class ids in [0, num_classes)
    valid: torch.Tensor,  # (N, M) bool: the slot holds a real object
    num_classes: int,
    out_h: int,
    out_w: int,
    down_ratio: int = 4,
) -> Dict[str, torch.Tensor]:
    """Targets of a batch (the JAX ``gen_centernet_targets_batch``) in the
    port's layout: hm (N, C, out_h, out_w) f32, wh (N, M, 2), reg (N, M, 2),
    ind (N, M) int64 (``y * out_w + x``), reg_mask (N, M) f32."""
    n, m = boxes.shape[:2]
    dev = boxes.device
    b = boxes.to(_F32) / float(down_ratio)
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    ok = valid.bool() & (h > 0) & (w > 0)

    # int() truncation then max(0, .), as the reference
    radius = torch.clamp(gaussian_radius(torch.ceil(h), torch.ceil(w)).to(torch.int32), min=0).to(_F32)
    cx = (b[..., 0] + b[..., 2]) / 2
    cy = (b[..., 1] + b[..., 3]) / 2
    cx_int = cx.to(torch.int32)
    cy_int = cy.to(torch.int32)

    ys = torch.arange(out_h, device=dev, dtype=_F32).view(1, 1, out_h, 1)
    xs = torch.arange(out_w, device=dev, dtype=_F32).view(1, 1, 1, out_w)
    dy = ys - cy_int.to(_F32).view(n, m, 1, 1)  # (N, M, H, 1)
    dx = xs - cx_int.to(_F32).view(n, m, 1, 1)  # (N, M, 1, W)
    r = radius.view(n, m, 1, 1)
    sigma = (2 * r + 1) / 6.0
    g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    in_window = (dx.abs() <= r) & (dy.abs() <= r)
    g = torch.where(in_window & ok.view(n, m, 1, 1), g, torch.zeros((), device=dev))

    seg = torch.where(ok, classes.long(), torch.zeros((), dtype=torch.long, device=dev))
    hm = torch.zeros(n, num_classes, out_h * out_w, device=dev, dtype=_F32)
    hm.scatter_reduce_(1, seg.view(n, m, 1).expand(n, m, out_h * out_w),
                       g.reshape(n, m, out_h * out_w), reduce="amax")

    okf = ok.to(_F32)
    wh = torch.stack([w, h], -1) * okf[..., None]
    reg = torch.stack([cx - cx_int, cy - cy_int], -1) * okf[..., None]
    ind = torch.where(ok, cy_int.long() * out_w + cx_int.long(), torch.zeros((), dtype=torch.long, device=dev))
    return {"hm": hm.view(n, num_classes, out_h, out_w), "wh": wh, "reg": reg, "ind": ind,
            "reg_mask": okf}
