"""Patchify / unpatchify (port of ``must3r_tpu/ops/patch.py``).

Feature layout inside a patch is channel-major (c * P*P + i * P + j), the
order of torch ``pixel_shuffle`` and of the reference conv patch-embed
weight flattened as [D, 3*P*P]. Any patch size: 16 (MUSt3R), 14 (VGGT).
"""

from __future__ import annotations

import torch


def patchify_positions(h_patches: int, w_patches: int,
                       device=None) -> torch.Tensor:
    """(y, x) coordinate per patch, row-major: [h*w, 2] int32."""
    ys = torch.arange(h_patches, dtype=torch.int32, device=device)
    xs = torch.arange(w_patches, dtype=torch.int32, device=device)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    return grid.reshape(h_patches * w_patches, 2)


def positions_with_special_tokens(h_patches: int, w_patches: int,
                                  n_special: int, device=None
                                  ) -> torch.Tensor:
    """RoPE positions of a frame that leads with ``n_special`` tokens (VGGT:
    camera and registers): (0, 0) for each of those, then (y + 1, x + 1)
    for the patches, row-major: [n_special + h*w, 2] int32. A token at
    (0, 0) is rotated by angle 0, so RoPE leaves it as it is."""
    return torch.cat([
        torch.zeros(n_special, 2, dtype=torch.int32, device=device),
        patchify_positions(h_patches, w_patches, device) + 1])


def unpatchify(x: torch.Tensor, patch_size: int, true_shape) -> torch.Tensor:
    """[B, N, P*P*C] tokens -> [B, H, W, C] image."""
    b, n, f = x.shape
    h, w = true_shape
    p = patch_size
    hp, wp = h // p, w // p
    if n != hp * wp:
        raise ValueError(f"{n} tokens do not tile {h}x{w} at patch {p}")
    c = f // (p * p)
    x = x.reshape(b, hp, wp, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c)


def patchify_image(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] image -> [B, N, P*P*C] tokens (inverse of unpatchify)."""
    b, h, w, c = img.shape
    p = patch_size
    hp, wp = h // p, w // p
    x = img.reshape(b, hp, p, wp, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, hp * wp, p * p * c)
