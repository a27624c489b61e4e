"""The work of a VGGT request, from the configuration and the traffic
alone, by the counting rules of ``work.py``: 2 FLOPs a multiply-add; an
attention 4 Dh per head per (query, key) pair; a convolution 2 x its
kernel's multiply-adds per output pixel (a transposed one, per input
pixel); a call's bytes each input read once and each output written once.

It adds to ``work.Work`` the least time of every self-attention that K1
runs (the tower's, the frame blocks' and the global blocks'; the camera
trunk's is not K1's): per call max(FLOPs / peak, bytes / bandwidth), with
q, k and v read and the output written, bf16.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.work import BF16, Work, least_s


@dataclass
class VGGTWork(Work):
    sa_s: float = 0.0            # least time of every K1 self-attention
    sa_calls: int = 0

    def scaled(self, k: float) -> "VGGTWork":
        base = Work.scaled(self, k)
        return VGGTWork(**vars(base), sa_s=self.sa_s * k,
                        sa_calls=int(self.sa_calls * k))


def block_token_flops(d: int, hidden: int) -> float:
    """Products of one pre-norm block for one token (qkv, proj, MLP)."""
    return 2 * (3 * d * d + d * d + 2 * d * hidden)


def sa_call(batch: int, n: int, d: int):
    """(FLOPs, least seconds) of one self-attention over ``batch``
    sequences of ``n`` tokens, width ``d`` (all heads)."""
    flops = batch * 4 * n * n * d
    return flops, least_s(flops, 4 * batch * n * d * BF16)


def _convs(specs) -> float:
    """Sum of 2 * pixels * c_in * c_out * k * k over (pixels, c_in, c_out,
    k)."""
    return sum(2 * px * ci * co * k * k for px, ci, co, k in specs)


def dpt_flops(cfg: dict, hw, n_out: int) -> float:
    """One DPT head on one frame."""
    p = cfg["encoder"]["patch_size"]
    c = cfg["camera_head"]["dim"]
    dpt = cfg["dpt_head"]
    f, oc = dpt["features"], dpt["out_channels"]
    hp, wp = hw[0] // p, hw[1] // p
    g = hp * wp
    sizes = [(4 * hp, 4 * wp), (2 * hp, 2 * wp), (hp, wp),
             ((hp + 1) // 2, (wp + 1) // 2)]
    px = [a * b for a, b in sizes]
    specs = [(g, c, o, 1) for o in oc]                       # projections
    specs += [(g, oc[0], oc[0], 4), (g, oc[1], oc[1], 2),    # resize
              (px[3], oc[3], oc[3], 3)]
    specs += [(px[i], oc[i], f, 3) for i in range(4)]        # layer_rn
    # fusion: refinenet4 one RCU at sizes[3]; 1-3 two RCUs at their input
    # size; each a 1 x 1 conv at the next size (x 2 after refinenet 1)
    specs += [(px[3], f, f, 3)] * 2 + [(px[2], f, f, 1)]
    for i, nxt in ((2, px[1]), (1, px[0]), (0, 4 * px[0])):
        specs += [(px[i], f, f, 3)] * 4 + [(nxt, f, f, 1)]
    full = hw[0] * hw[1]
    specs += [(4 * px[0], f, f // 2, 3), (full, f // 2, 32, 3),
              (full, 32, n_out, 1)]
    return _convs(specs)


def camera_flops(cfg: dict, n_frames: int) -> float:
    cam = cfg["camera_head"]
    c = cam["dim"]
    hidden = int(c * cam["mlp_ratio"])
    per_iter = n_frames * (2 * 9 * c + 2 * c * 3 * c
                           + cam["trunk_depth"] * block_token_flops(c, hidden)
                           + 2 * (c * c // 2 + c // 2 * 9))
    per_iter += cam["trunk_depth"] * 4 * n_frames * n_frames * c
    return cam["iterations"] * per_iter


def vggt_request(cfg: dict, hw, n_frames: int) -> VGGTWork:
    """One scene of ``n_frames`` frames: the tower, frame and global blocks
    (products and attention), the camera head, both DPT heads."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    p, d = enc["patch_size"], enc["embed_dim"]
    g = (hw[0] // p) * (hw[1] // p)
    n = 1 + enc["num_register_tokens"] + g       # cls or camera, registers
    w = VGGTWork()
    w.flops += n_frames * 2 * g * 3 * p * p * d               # patch embed
    tok = block_token_flops(d, int(d * enc["mlp_ratio"]))
    w.flops += enc["depth"] * n_frames * n * tok
    tok = block_token_flops(dec["embed_dim"],
                            int(dec["embed_dim"] * dec["mlp_ratio"]))
    w.flops += 2 * dec["depth"] * n_frames * n * tok
    calls = ([(n_frames, n, d)] * enc["depth"]
             + [(n_frames, n, dec["embed_dim"])] * dec["depth"]
             + [(1, n_frames * n, dec["embed_dim"])] * dec["depth"])
    for batch, length, width in calls:
        f, s = sa_call(batch, length, width)
        w.flops += f
        w.sa_s += s
        w.sa_calls += 1
    w.flops += camera_flops(cfg, n_frames)
    dpt = cfg["dpt_head"]
    w.flops += n_frames * (dpt_flops(cfg, hw, dpt["depth_channels"])
                           + dpt_flops(cfg, hw, dpt["point_channels"]))
    return w
