"""Camera recovery from pointmaps (port of ``must3r_tpu/ops/pose.py``):
Weiszfeld focal and Horn-quaternion weighted Procrustes.

The algorithms are the JAX package's, step for step: 10 unrolled IRLS
iterations for the focal; for the rotation, Horn's 4x4 K matrix shifted by
its Frobenius norm, 6 normalised squarings and an asymmetric seed vector.
An SVD would pick other rotations on degenerate inputs.
"""

from __future__ import annotations

import math

import torch

from must3r_tpu_torch.ops.transfer import upload

_EPS = 1e-8


def xy_pixel_grid(h: int, w: int, device=None) -> torch.Tensor:
    """[H*W, 2] (x, y) pixel coordinates, row-major over the image."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx, gy], dim=-1).reshape(h * w, 2)


def estimate_focal_weiszfeld(pts3d_local: torch.Tensor, n_iters: int = 10,
                             min_focal: float = 0.0,
                             max_focal: float = math.inf) -> torch.Tensor:
    """Robust focal from a camera-frame pointmap [..., H, W, 3] -> [...]
    (principal point at the image centre)."""
    *lead, h, w, _ = pts3d_local.shape
    pts = pts3d_local.reshape(-1, h * w, 3).float()
    pp = upload([w / 2.0, h / 2.0], pts.device, torch.float32)
    pixels = xy_pixel_grid(h, w, pts.device)[None] - pp       # [1, HW, 2]

    z = pts[..., 2:3]
    xy_over_z = pts[..., :2] / torch.where(z.abs() < _EPS,
                                           torch.full_like(z, _EPS), z)
    xy_over_z = torch.nan_to_num(xy_over_z, nan=0.0, posinf=0.0,
                                 neginf=0.0)
    dot_xy_px = (xy_over_z * pixels).sum(dim=-1)               # [B, HW]
    dot_xy_xy = xy_over_z.square().sum(dim=-1)

    focal = dot_xy_px.mean(dim=1) / dot_xy_xy.mean(dim=1).clamp_min(_EPS)
    for _ in range(n_iters):
        dis = torch.linalg.vector_norm(
            pixels - focal[:, None, None] * xy_over_z, dim=-1)
        wgt = 1.0 / dis.clamp_min(_EPS)
        focal = ((wgt * dot_xy_px).mean(dim=1)
                 / (wgt * dot_xy_xy).mean(dim=1).clamp_min(_EPS))
    focal = focal.clamp(min_focal, max_focal)
    return focal.reshape(lead)


def _quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(*q.shape[:-1], 3, 3)


def _fro(m: torch.Tensor) -> torch.Tensor:
    return m.square().sum(dim=(-2, -1), keepdim=True).sqrt()


def rigid_points_registration(x: torch.Tensor, y: torch.Tensor,
                              weights=None, n_power_iters: int = 64):
    """Weighted Procrustes: R, T minimising sum_i w_i ||R x_i + T - y_i||^2.

    x, y: [..., N, 3]; weights: optional [..., N] (clipped at 0).
    Returns (R [..., 3, 3] with det +1, T [..., 3])."""
    xf = x.float()
    yf = y.float()
    if weights is None:
        weights = torch.ones(xf.shape[:-1], dtype=torch.float32,
                             device=xf.device)
    wf = weights.float().clamp_min(0.0)
    wn = wf / wf.sum(dim=-1, keepdim=True).clamp_min(_EPS)     # [..., N]

    cx = (wn[..., None] * xf).sum(dim=-2)                      # [..., 3]
    cy = (wn[..., None] * yf).sum(dim=-2)
    xc = xf - cx[..., None, :]
    yc = yf - cy[..., None, :]
    s = torch.einsum("...n,...ni,...nj->...ij", wn, xc, yc)   # [..., 3, 3]

    sxx, sxy, sxz = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    syx, syy, syz = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    szx, szy, szz = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    k = torch.stack([
        sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
        syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
        szx - sxz, sxy + syx, syy - sxx - szz, syz + szy,
        sxy - syx, szx + sxz, syz + szy, szz - sxx - syy,
    ], dim=-1).reshape(*s.shape[:-2], 4, 4)

    # shift by ||K||_F so the matrix is positive definite, then power-iterate
    # by repeated normalised squaring
    eye = torch.eye(4, dtype=k.dtype, device=k.device)
    k_sh = k + (_fro(k) + _EPS) * eye
    n_sq = max(1, int(math.ceil(math.log2(max(n_power_iters, 2)))))
    m_pow = k_sh / _fro(k_sh).clamp_min(_EPS)
    for _ in range(n_sq):
        m_pow = m_pow @ m_pow
        m_pow = m_pow / _fro(m_pow).clamp_min(_EPS)
    seed = upload([1.0, 0.011, 0.017, 0.023], k.device, k.dtype)
    q = torch.einsum("...ij,...j->...i", m_pow,
                     seed.expand(*k.shape[:-2], 4))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)
    r = _quat_to_rotmat(q)
    t = cy - torch.einsum("...ij,...j->...i", r, cx)
    return r, t


def geotrf(trf: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [..., 4, 4] (or [..., 3, 4]) rigid transform to [..., N, 3]."""
    r = trf[..., :3, :3]
    t = trf[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", r, pts) + t[..., None, :]


def inv_se3(trf: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 4, 4] rigid transform."""
    rt = trf[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", rt, trf[..., :3, 3])
    out = torch.zeros_like(trf)
    out[..., :3, :3] = rt
    out[..., :3, 3] = ti
    out[..., 3, 3] = 1.0
    return out


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] camera-to-world from R, T."""
    c2w = torch.zeros((*r.shape[:-2], 4, 4), dtype=torch.float32,
                      device=r.device)
    c2w[..., :3, :3] = r
    c2w[..., :3, 3] = t
    c2w[..., 3, 3] = 1.0
    return c2w


def pose_encoding_to_cameras(pose_enc: torch.Tensor, img_hw):
    """VGGT's pose encoding [..., 9] (T, a quaternion with the scalar last,
    FoV_h, FoV_w; the camera from the world, OpenCV axes) -> (c2w [..., 4,
    4], focal [..., 2] = (f_x, f_y) in pixels of an H x W image with the
    principal point at its centre)."""
    enc = pose_enc.float()
    x, y, z, w = enc[..., 3:7].unbind(-1)
    rot = _quat_to_rotmat(torch.stack([w, x, y, z], dim=-1)
                          / enc[..., 3:7].norm(dim=-1, keepdim=True))
    rt = rot.transpose(-1, -2)
    c2w = make_c2w(rt, -torch.einsum("...ij,...j->...i", rt, enc[..., :3]))
    h, w_ = img_hw
    focal = torch.stack([(w_ / 2.0) / torch.tan(enc[..., 8] / 2.0),
                         (h / 2.0) / torch.tan(enc[..., 7] / 2.0)], dim=-1)
    return c2w, focal
