"""The pre-norm encoder block's fused path (``models/layers.py``:
``use_block_glue``, ``glued_block``; ``ops/block_glue.py``: G1-G4 and
their plain statements; ``csrc/block_glue_sm90.cu``: the kernels).

On the CPU: the gate as a pure function; each plain statement against the
plain composition it replaces (``linear``, ``layer_norm``, ``self_attn``,
``scaled_add``, ``gelu``), bit for bit, with VGGT's options (an fp32
residual stream, LayerScale, QK-norm, RoPE tables shared by the batch or
tiled over a scene) and MUSt3R's (a bf16 stream, per-image tables); the
whole block through the plain statements against ``encoder_block``, bit
for bit; the counters of a tiny VGGT request; the wrappers refusing CPU
tensors.

On the card (marked ``cuda``, skipped without one): each kernel against
its plain statement at VGGT's widths (1024, 3072, 4096) and MUSt3R's
(1024) with fp32 and bf16 streams, by ``tools/parity.py::bf16_agreement``
(the LayerNorms' fp32 statistics are summed in another order, which moves
a value across a bf16 rounding boundary now and then: one ulp, or a few
fp32 ulps of the terms where a value cancels to near 0; everything else
rounds at the same points and agrees bit for bit); one VGGT aggregator
block and one
MUSt3R encoder block fused against the plain composition with the same
K1; the counters and launches of a tiny VGGT request. This file imports
no jax:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_block_glue.py -q
"""

import pytest
import torch

from must3r_tpu_torch.config import VGGTConfig
from must3r_tpu_torch.models import layers as L
from must3r_tpu_torch.ops import _kernels
from must3r_tpu_torch.ops import attention as tatt
from must3r_tpu_torch.ops import block_glue as G
from must3r_tpu_torch.ops.rope import make_rope_tables
from must3r_tpu_torch.tools.parity import bf16_agreement, rel_rmse

BF16, F32 = torch.bfloat16, torch.float32
VGGT = dict(ls=True, qkn=True, stream=F32, dtype=BF16, eps=1e-5)
TOWER = dict(ls=True, qkn=False, stream=F32, dtype=BF16, eps=1e-6)
MUST3R = dict(ls=False, qkn=False, stream=BF16, dtype=None, eps=1e-6)


def make_block(opts, d, heads, gen, device="cpu"):
    """An EncoderBlock with every parameter random (biases and LayerNorm
    affines off their init, LayerScale near VGGT's), on ``device``."""
    p = L.EncoderBlock(d, 4.0, opts["eps"], layer_scale=opts["ls"],
                       qk_norm=opts["qkn"], num_heads=heads, qk_eps=1e-5)
    with torch.no_grad():
        for name, t in p.named_parameters():
            r = torch.randn(t.shape, generator=gen)
            if name.endswith("gamma"):
                t.copy_(0.01 + 0.005 * r)
            elif t.dim() == 1 and name.endswith("weight"):
                t.copy_(1.0 + 0.1 * r)
            elif t.dim() == 1:
                t.copy_(0.1 * r)
            else:
                t.copy_(r / t.shape[1] ** 0.5)
    return p.to(device).requires_grad_(False)


def rope_tables(b, n, gen, device="cpu"):
    pos = torch.randint(0, 40, (b, n, 2), generator=gen)
    return tuple(t.to(device) for t in make_rope_tables(pos, G.HEAD_DIM,
                                                        base=100.0))


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

# (on_cuda, impl, needs_grad, branch, stream, width, hidden, heads)
FUSED = [
    ("vggt aggregator", (True, None, False, BF16, F32, 1024, 4096, 16)),
    ("must3r encoder", (True, None, False, BF16, BF16, 1024, 4096, 16)),
    ("tiny encoder", (True, None, False, BF16, BF16, 256, 1024, 4)),
]
PLAIN = [
    ("cpu", (False, None, False, BF16, BF16, 1024, 4096, 16)),
    ("impl plain", (True, "plain", False, BF16, F32, 1024, 4096, 16)),
    ("fp32 camera trunk", (True, None, False, F32, F32, 2048, 8192, 16)),
    ("gradient needed", (True, None, True, BF16, BF16, 1024, 4096, 16)),
    ("head dim 128", (True, None, False, BF16, F32, 2048, 8192, 16)),
    ("fp16 stream", (True, None, False, BF16, torch.float16, 1024, 4096,
                     16)),
    ("wider than a warp's registers", (True, None, False, BF16, F32, 4096,
                                       16384, 64)),
    ("ragged hidden", (True, None, False, BF16, F32, 1024, 4100, 16)),
]


@pytest.mark.parametrize("case", [c for _, c in FUSED],
                         ids=[n for n, _ in FUSED])
def test_gate_takes_the_fused_path(case):
    assert L.use_block_glue(*case)


@pytest.mark.parametrize("case", [c for _, c in PLAIN],
                         ids=[n for n, _ in PLAIN])
def test_gate_keeps_the_plain_path(case):
    assert not L.use_block_glue(*case)


def test_gate_refuses_an_unknown_impl():
    with pytest.raises(ValueError):
        L.use_block_glue(True, "fast", False, BF16, F32, 1024, 4096, 16)


# ---------------------------------------------------------------------------
# The plain statements against the plain composition, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [F32, BF16])
def test_plain_ln_cast_is_norm1(stream):
    gen = torch.Generator().manual_seed(1)
    p = make_block(VGGT, 128, 2, gen)
    x = torch.randn(37, 128, generator=gen).to(stream)
    want = L.layer_norm(p.norm1, x, BF16)
    got = G.ln_cast(x, p.norm1.weight.float(), p.norm1.bias.float(),
                    p.norm1.eps)
    assert got.dtype == BF16 and torch.equal(got, want)


def _captured_qkv(monkeypatch, p, x, rope, heads):
    """(q, k, v) as ``self_attn`` hands them to the attention."""
    seen = {}

    def capture(q, k, v, impl=None):
        seen["qkv"] = (q, k, v)
        return v
    monkeypatch.setattr(L, "self_attention", capture)
    L.self_attn(p.attn, x, rope=rope, num_heads=heads, impl="plain")
    return seen["qkv"]


@pytest.mark.parametrize("opts,rope_b", [
    (VGGT, 1),        # the frame block: tables shared by the frames
    (VGGT, "scene"),  # the global block: one sequence, tables tiled
    (TOWER, None),    # the DINOv2 tower: neither QK-norm nor RoPE
    (MUST3R, "B"),    # MUSt3R's encoder: a table per image
], ids=["vggt-frame", "vggt-global", "vggt-tower", "must3r"])
def test_plain_qkv_glue_is_self_attn_before_the_attention(monkeypatch, opts,
                                                           rope_b):
    gen = torch.Generator().manual_seed(2)
    d, heads, b, n = 128, 2, 3, 11
    p = make_block(opts, d, heads, gen)
    rope = None
    if rope_b == 1:
        rope = rope_tables(1, n, gen)
    elif rope_b == "B":
        rope = rope_tables(b, n, gen)
    elif rope_b == "scene":
        rope = tuple(t.repeat(1, b, 1, 1) for t in rope_tables(1, n, gen))
        b, n = 1, b * n
    xn = torch.randn(b, n, d, generator=gen).to(BF16)
    want = _captured_qkv(monkeypatch, p, xn, rope, heads)
    a = p.attn
    qk = {}
    if opts["qkn"]:
        qk = dict(q_norm=(a.q_norm.weight, a.q_norm.bias),
                  k_norm=(a.k_norm.weight, a.k_norm.bias), eps=a.q_norm.eps)
    got = G.qkv_glue(G.product(xn.reshape(b * n, d), a.qkv.weight),
                     a.qkv.bias, b, n, rope=rope, **qk)
    for g_, w_ in zip(got, want):
        assert g_.is_contiguous() and g_.dtype == BF16
        assert g_.shape == (b, n, heads, G.HEAD_DIM)
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("opts", [VGGT, MUST3R], ids=["vggt", "must3r"])
@pytest.mark.parametrize("inplace", [False, True])
def test_plain_residual_glue_is_the_residual_add_and_norm2(opts, inplace):
    gen = torch.Generator().manual_seed(3)
    p = make_block(opts, 128, 2, gen)
    x = torch.randn(29, 128, generator=gen).to(opts["stream"])
    o = torch.randn(29, 128, generator=gen).to(BF16)
    h = L.linear(p.attn.proj, o)
    want_x = L.scaled_add(x, h, p.ls1) if opts["ls"] else x + h
    want_xn = L.layer_norm(p.norm2, want_x, BF16)
    before = x.clone()
    got_x, got_xn = G.residual_glue(
        G.product(o, p.attn.proj.weight), p.attn.proj.bias, x,
        p.ls1.gamma if opts["ls"] else None,
        norm=(p.norm2.weight, p.norm2.bias), eps=p.norm2.eps,
        inplace=inplace)
    assert got_x.dtype == x.dtype and torch.equal(got_x, want_x)
    assert torch.equal(got_xn, want_xn)
    assert (got_x.data_ptr() == x.data_ptr()) == inplace
    if not inplace:
        assert torch.equal(x, before)


def test_plain_bias_gelu_is_fc1_and_gelu():
    gen = torch.Generator().manual_seed(4)
    p = make_block(VGGT, 128, 2, gen)
    h = (3 * torch.randn(23, 128, generator=gen)).to(BF16)
    want = L.gelu(L.linear(p.mlp.fc1, h))
    got = G.bias_gelu(G.product(h, p.mlp.fc1.weight), p.mlp.fc1.bias)
    assert got.dtype == BF16 and torch.equal(got, want)


@pytest.mark.parametrize("opts,rope_b", [
    (VGGT, 1), (VGGT, "scene"), (TOWER, None), (MUST3R, "B")],
    ids=["vggt-frame", "vggt-global", "vggt-tower", "must3r"])
def test_glued_block_through_the_plain_statements_is_encoder_block(opts,
                                                                    rope_b):
    """The fused path's structure (which glue reads which product, where
    x is written in place) on the CPU: bit for bit the plain block, and
    the caller's x untouched."""
    gen = torch.Generator().manual_seed(5)
    d, heads, b, n = 128, 2, 2, 13
    p = make_block(opts, d, heads, gen)
    rope = None
    if rope_b == 1:
        rope = rope_tables(1, n, gen)
    elif rope_b == "B":
        rope = rope_tables(b, n, gen)
    elif rope_b == "scene":
        rope = tuple(t.repeat(1, b, 1, 1) for t in rope_tables(1, n, gen))
        b, n = 1, b * n
    x = torch.randn(b, n, d, generator=gen).to(opts["stream"])
    before = x.clone()
    want = L.encoder_block(p, x, rope, heads, impl="plain",
                           dtype=opts["dtype"])
    got = L.glued_block(p, x, rope, glue=G.PLAIN)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(x, before)


def tiny_vggt_cfg():
    """Width 128 in two heads of 64 (the fused path's), a 1-block camera
    trunk of 256 in two heads of 128 (the plain one's)."""
    return VGGTConfig(img_size=70, embed_dim=128, num_heads=2, tower_depth=2,
                      depth=2, camera_trunk_depth=1, camera_num_heads=2,
                      dpt_features=32, dpt_out_channels=(16, 32, 64, 64),
                      dpt_layers=(0, 0, 1, 1), dpt_frames_chunk=2)


def _counted_request(device, dtype):
    from must3r_tpu_torch.checkpoint import init_vggt
    from must3r_tpu_torch.engine.inference import (VGGTCore,
                                                   vggt_reconstruction)
    cfg = tiny_vggt_cfg()
    core = VGGTCore(init_vggt(cfg, seed=3, device=device), dtype=dtype)
    imgs = torch.rand(3, 56, 70, 3, generator=torch.Generator().manual_seed(
        6)).to(device)
    L.reset_glue_counts()
    tatt.reset_launch_counts()
    vggt_reconstruction(core, imgs)
    return cfg, L.glue_counts(), tatt.launch_counts()


def test_glue_counts_of_a_tiny_vggt_request_on_the_cpu():
    """Every block plain on the CPU, counted: the tower, the frame and
    global blocks and the camera trunk run camera_iterations times."""
    cfg, counts, launches = _counted_request("cpu", BF16)
    blocks = cfg.tower_depth + 2 * cfg.depth
    trunk = cfg.camera_trunk_depth * cfg.camera_iterations
    assert counts == {"fused_blocks": 0, "plain_blocks": blocks + trunk}
    assert not any(launches.values())
    L.reset_glue_counts()
    assert L.glue_counts() == {"fused_blocks": 0, "plain_blocks": 0}


@pytest.mark.parametrize("name", ["ln_cast", "qkv_glue", "residual_glue",
                                  "bias_gelu"])
def test_glue_wrappers_refuse_cpu_tensors(name):
    """No fallback: a CPU tensor raises before anything is built."""
    y = torch.zeros(4, 3 * 128)
    args = {"ln_cast": (torch.zeros(4, 128), torch.ones(128),
                        torch.zeros(128), 1e-6),
            "qkv_glue": (y, torch.zeros(3 * 128), 1, 4),
            "residual_glue": (torch.zeros(4, 128), torch.zeros(128),
                              torch.zeros(4, 128)),
            "bias_gelu": (torch.zeros(4, 512), torch.zeros(512))}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(_kernels, name)(*args)
    assert getattr(_kernels, name) in _kernels.KERNELS
    assert name in tatt.launch_counts()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernels G1-G4)")
    return torch.device("cuda")


def assert_within_one_ulp(got, want):
    """``tools/parity.py``'s rule: within one bf16 ulp (or, where an
    output cancels to near 0, a few fp32 ulps of its terms), 99.9 % equal."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    e = bf16_agreement(got, want)
    assert e["ok"], e


def _cuda_block(opts, d, heads, dev, seed):
    return make_block(opts, d, heads, torch.Generator().manual_seed(seed),
                      dev)


ROWS = 2 * 1041       # two VGGT frames of 1,041 tokens


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [F32, BF16])
def test_ln_cast_kernel_matches_plain(dev, stream):
    p = _cuda_block(VGGT, 1024, 16, dev, 10)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(ROWS, 1024, generator=gen, device=dev) * 3 + 0.5
         ).to(stream)
    w, b = p.norm1.weight.float(), p.norm1.bias.float()
    before = _kernels.ln_cast.launches
    got = _kernels.ln_cast(x, w, b, 1e-6)
    assert _kernels.ln_cast.launches == before + 1
    assert_within_one_ulp(got, G.ln_cast(x, w, b, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("opts,rope_b", [(VGGT, 1), (VGGT, "scene"),
                                         (TOWER, None), (MUST3R, "B")],
                         ids=["vggt-frame", "vggt-global", "vggt-tower",
                              "must3r"])
def test_qkv_glue_kernel_matches_plain(dev, opts, rope_b):
    p = _cuda_block(opts, 1024, 16, dev, 11)
    gen = torch.Generator().manual_seed(1)
    b, n = 2, 1041
    rope = None
    if rope_b == 1:
        rope = rope_tables(1, n, gen, dev)
    elif rope_b == "B":
        rope = rope_tables(b, n, gen, dev)
    elif rope_b == "scene":
        rope = tuple(t.repeat(1, b, 1, 1) for t in rope_tables(1, n, gen,
                                                               dev))
        b, n = 1, b * n
    y = torch.randn(b * n, 3072, generator=gen).to(dev)
    a = p.attn
    qk = {}
    if opts["qkn"]:
        qk = dict(q_norm=(a.q_norm.weight, a.q_norm.bias),
                  k_norm=(a.k_norm.weight, a.k_norm.bias), eps=a.q_norm.eps)
    got = _kernels.qkv_glue(y, a.qkv.bias, b, n, rope=rope, **qk)
    want = G.qkv_glue(y, a.qkv.bias, b, n, rope=rope, **qk)
    for g_, w_ in zip(got, want):
        assert g_.shape == (b, n, 16, 64) and g_.is_contiguous()
        assert_within_one_ulp(g_, w_)
    assert torch.equal(got[2], want[2])            # v: bias and rounding
    if not opts["qkn"]:                            # RoPE alone: same ops
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [VGGT, MUST3R], ids=["vggt", "must3r"])
@pytest.mark.parametrize("norm,inplace", [(True, False), (False, True)],
                         ids=["after-proj", "after-fc2"])
def test_residual_glue_kernel_matches_plain(dev, opts, norm, inplace):
    p = _cuda_block(opts, 1024, 16, dev, 12)
    gen = torch.Generator(device=dev).manual_seed(2)
    y = torch.randn(ROWS, 1024, generator=gen, device=dev)
    x = torch.randn(ROWS, 1024, generator=gen, device=dev).to(opts["stream"])
    gamma = p.ls1.gamma if opts["ls"] else None
    nrm = (p.norm2.weight, p.norm2.bias) if norm else None
    want_x, want_xn = G.residual_glue(y, p.attn.proj.bias, x, gamma, nrm,
                                      p.norm2.eps)
    x_in = x.clone()
    got_x, got_xn = _kernels.residual_glue(y, p.attn.proj.bias, x_in, gamma,
                                           nrm, p.norm2.eps, inplace=inplace)
    assert (got_x.data_ptr() == x_in.data_ptr()) == inplace
    if not inplace:
        assert torch.equal(x_in, x)
    if opts["stream"] == BF16:
        assert torch.equal(got_x, want_x)
    else:
        # x + (gamma * h): addcmul may fuse the product and the add, the
        # kernel rounds the product first; one fp32 rounding apart
        h = (y + p.attn.proj.bias).to(BF16).float()
        bound = 2.0 ** -23 * (x.abs() + (gamma * h).abs())
        assert bool(((got_x - want_x).abs() <= bound).all())
    if norm:
        assert_within_one_ulp(got_xn, want_xn)
    else:
        assert got_xn is None


@pytest.mark.cuda
def test_bias_gelu_kernel_matches_plain(dev):
    p = _cuda_block(VGGT, 1024, 16, dev, 13)
    gen = torch.Generator(device=dev).manual_seed(3)
    y = 3 * torch.randn(ROWS, 4096, generator=gen, device=dev)
    got = _kernels.bias_gelu(y, p.mlp.fc1.bias)
    assert_within_one_ulp(got, G.bias_gelu(y, p.mlp.fc1.bias))


@pytest.mark.cuda
@pytest.mark.parametrize("opts,rope_b", [(VGGT, 1), (VGGT, "scene"),
                                         (TOWER, None), (MUST3R, "B")],
                         ids=["vggt-frame", "vggt-global", "vggt-tower",
                              "must3r"])
def test_fused_block_matches_the_plain_block(dev, monkeypatch, opts, rope_b):
    """One block at full width, fused against the plain composition with
    the same K1 (the gate switched off): an fp32 stream within 1e-5 of its
    norm; a bf16 stream as accurate as the plain one against the block in
    fp32 (``impl="plain"``), within 2 % of its relative RMSE. Bit agreement
    is no measure of a whole bf16 block: a LayerNorm rounding one element
    the other way moves every token through the attention, and the plain
    block against itself with its LayerNorms summed in fp64 agrees within
    one ulp in only ~93 % of its elements (each G1-G4 is held to one ulp
    above)."""
    p = _cuda_block(opts, 1024, 16, dev, 14)
    gen = torch.Generator().manual_seed(4)
    b, n = 2, 1041
    rope = None
    if rope_b == 1:
        rope = rope_tables(1, n, gen, dev)
    elif rope_b == "B":
        rope = rope_tables(b, n, gen, dev)
    elif rope_b == "scene":
        rope = tuple(t.repeat(1, b, 1, 1) for t in rope_tables(1, n, gen,
                                                               dev))
        b, n = 1, b * n
    x = torch.randn(b, n, 1024, generator=gen).to(dev, opts["stream"])
    with torch.no_grad():
        L.reset_glue_counts()
        tatt.reset_launch_counts()
        got = L.encoder_block(p, x, rope, 16, dtype=opts["dtype"])
        assert L.glue_counts()["fused_blocks"] == 1
        counts = tatt.launch_counts()
        assert (counts["ln_cast"], counts["qkv_glue"], counts["residual_glue"],
                counts["bias_gelu"], counts["sa_fwd"]) == (1, 1, 2, 1, 1)
        monkeypatch.setattr(L, "use_block_glue", lambda *a: False)
        want = L.encoder_block(p, x, rope, 16, dtype=opts["dtype"])
        exact = (L.encoder_block(p, x.float(), rope, 16, impl="plain")
                 if opts["stream"] == BF16 else None)
    assert got.dtype == want.dtype == opts["stream"]
    if exact is not None:
        e_fused, e_plain = rel_rmse(got, exact), rel_rmse(want, exact)
        assert e_fused <= 1.02 * e_plain, (e_fused, e_plain)
    else:
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-5, rel


@pytest.mark.cuda
def test_glue_counts_of_a_tiny_vggt_request(dev):
    """The tower, frame and global blocks fused, the fp32 camera trunk
    plain; each kernel launched as the schedule says."""
    cfg, counts, launches = _counted_request(dev, BF16)
    blocks = cfg.tower_depth + 2 * cfg.depth
    trunk = cfg.camera_trunk_depth * cfg.camera_iterations
    assert counts == {"fused_blocks": blocks, "plain_blocks": trunk}
    assert (launches["ln_cast"], launches["qkv_glue"],
            launches["residual_glue"], launches["bias_gelu"],
            launches["sa_fwd"]) == (blocks, blocks, 2 * blocks, blocks,
                                    blocks)
