"""VGGT in the PyTorch port against the benchmark's plain float32 reference
(``benchmark/reference/vggt.py``), on the CPU at a tiny size: the same
seeded weights (``benchmark/vggt_weights.py``) in both, every output
compared; then the mechanisms one by one (the first frame's own tokens,
frame permutation, the special tokens' RoPE, the resized position
embedding, global attention of one frame), the shared block functions
with the new options off, checkpoints, the entries and the CLI. The test
marked ``cuda`` holds K1 to its plain version at VGGT's shapes.

Tolerances, each with its reason:
  * program vs reference, fp32: 1e-5 of each output's norm per frame (the
    readings are ~1e-6). The two compute the same float32 arithmetic in
    another order (the plain attention's online softmax over 1024-key
    chunks against a dense one, LayerScale added with one rounding, RoPE
    by another pairing), and exp / expm1 at the heads' ends grow a
    relative error by the size of their argument;
  * another frame first, or global attention cut to frames, moves every
    output by more than 10 x that, and the cameras by more than 0.1 of
    their norm (the seeded LayerScale of 0.01 keeps the maps' change
    small: a block adds a hundredth of its branch).

This file imports no jax, so on a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vggt.py -q
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import vggt as ref
from benchmark.vggt_weights import make_weights
from must3r_tpu_torch.checkpoint import (load_vggt, load_vggt_checkpoint,
                                         save_vggt_checkpoint)
from must3r_tpu_torch.config import (VGGTConfig, config_from_json,
                                     config_to_json, vggt_1b_config)
from must3r_tpu_torch.engine.inference import VGGTCore, vggt_reconstruction
from must3r_tpu_torch.models import layers as L
from must3r_tpu_torch.models import vggt as V
from must3r_tpu_torch.ops import attention as tatt
from must3r_tpu_torch.ops.patch import positions_with_special_tokens
from must3r_tpu_torch.ops.rope import apply_rope2d, make_rope_tables
from must3r_tpu_torch.tools.parity import kernel_error

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 77
OUTPUTS = ("world_points", "world_points_conf", "depth", "depth_conf",
           "pose_enc")
TOL = 1e-5
HW = (56, 70)


def tiny_cfg_dict():
    """The benchmark's vggt_1b configuration at a tiny size: 2 tower
    blocks, 2 aggregator iterations, width 128 in 2 heads of 64, a 1-block
    camera trunk (heads of 128), DPT features 32."""
    with open(ROOT / "benchmark" / "configs" / "vggt_1b.json") as f:
        cfg = json.load(f)
    cfg["encoder"].update(img_size=70, embed_dim=128, depth=2, num_heads=2)
    cfg["decoder"].update(embed_dim=128, depth=2, num_heads=2)
    cfg["camera_head"].update(dim=256, trunk_depth=1, num_heads=2)
    cfg["dpt_head"].update(features=32, out_channels=[16, 32, 64, 64],
                           layers=[0, 0, 1, 1], frames_chunk=2)
    return cfg


def program_cfg(cfg):
    from benchmark.drivers.vggt_scene import program_config
    return program_config(cfg)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg_dict()
    weights = make_weights(cfg, SEED, "cpu")
    gen = torch.Generator().manual_seed(5)
    imgs = torch.rand(3, *HW, 3, generator=gen)
    with torch.no_grad():
        want = ref.forward(weights, cfg, imgs)
    return cfg, weights, imgs, want


def program(cfg, weights, dtype=torch.float32):
    return VGGTCore(load_vggt(weights, program_cfg(cfg), "cpu"), dtype=dtype)


def gap(a, b):
    """Worst frame's ||a - b|| / ||b||."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    num = (a - b).reshape(a.shape[0], -1).norm(dim=1)
    return float((num / b.reshape(b.shape[0], -1).norm(dim=1)).max())


# -- the whole model -------------------------------------------------------

def test_program_matches_the_reference_in_fp32(tiny):
    cfg, weights, imgs, want = tiny
    V.reset_vggt_counts()
    got = vggt_reconstruction(program(cfg, weights), imgs)
    for k in OUTPUTS:
        assert got[k].shape == want[k].shape, k
        assert gap(got[k], want[k]) < TOL, (k, gap(got[k], want[k]))
    # the counters: 3 frames, 2 global layers of 3 x (5 + 20) tokens, one
    # chunk of 2 frames and one of 1 in each DPT head
    assert V.vggt_counts() == {"frames": 3, "global_tokens": 2 * 3 * 25,
                               "dpt_chunks": 4}


def test_kept_iterations_match_the_reference(tiny):
    cfg, weights, imgs, _ = tiny
    got = vggt_reconstruction(program(cfg, weights), imgs,
                              return_layers=True)["layers"]
    with torch.no_grad():
        want = ref.aggregator(weights, cfg, imgs)
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        assert gap(got[i], want[i]) < TOL


def test_heads_alone_match_the_reference(tiny):
    cfg, weights, imgs, _ = tiny
    core = program(cfg, weights)
    with torch.no_grad():
        layers = ref.aggregator(weights, cfg, imgs)
        want = ref.heads(weights, cfg, layers, HW)
        got = V.heads_forward(core.model, layers, HW)
    for k in OUTPUTS:
        assert gap(got[k], want[k]) < TOL, k


def test_bf16_program_stays_near_the_reference(tiny):
    """The bf16 aggregator (fp32 residual, statistics and heads): within a
    per cent or two, the bf16 rounding of every product's operands."""
    cfg, weights, imgs, want = tiny
    got = vggt_reconstruction(program(cfg, weights, torch.bfloat16), imgs)
    for k in OUTPUTS:
        assert gap(got[k], want[k]) < 0.02, k


def test_first_frame_tokens_and_frame_permutation(tiny):
    """Frames 1 .. S-1 permuted: the outputs permute with them. Another
    frame moved to index 0: every output changes (frame 0 has camera and
    register tokens of its own)."""
    cfg, weights, imgs, want = tiny
    core = program(cfg, weights)
    got = vggt_reconstruction(core, imgs[[0, 2, 1]])
    for k in OUTPUTS:
        assert gap(got[k], want[k][[0, 2, 1]]) < TOL, k
    moved = vggt_reconstruction(core, imgs[[1, 0, 2]])
    for k in OUTPUTS:
        assert gap(moved[k][[1, 0, 2]], want[k]) > 10 * TOL, k
    assert gap(moved["pose_enc"][[1, 0, 2]], want["pose_enc"]) > 0.1


def test_first_frame_fault_is_seen(tiny):
    """Frame 0 given the others' camera and register tokens moves the
    outputs far past the tolerance."""
    cfg, weights, imgs, want = tiny
    faulty = dict(weights)
    for name in ("aggregator.camera_token", "aggregator.register_token"):
        t = weights[name].clone()
        t[:, 0] = t[:, 1]
        faulty[name] = t
    got = vggt_reconstruction(program(cfg, faulty), imgs)
    assert max(gap(got[k], want[k]) for k in OUTPUTS) > 1e-2
    with torch.no_grad():
        r = ref.forward(weights, cfg, imgs, fault="first_frame")
    for k in OUTPUTS:
        assert gap(got[k], r[k]) < TOL, k


def frame_only_global_block(p, x, rope, num_heads, *a, **k):
    """The fault: a global block that attends within each frame (the
    frame's tables are the first P rows of the scene's)."""
    return L.encoder_block(p, x, tuple(t[:, :x.shape[1]] for t in rope),
                           num_heads, *a, **k)


def test_global_attention_reaches_across_frames(tiny, monkeypatch):
    """Global attention cut to each frame: outputs move past the
    tolerance, and agree with the reference's same fault."""
    cfg, weights, imgs, want = tiny
    monkeypatch.setattr(V, "global_block", frame_only_global_block)
    got = vggt_reconstruction(program(cfg, weights), imgs)
    assert max(gap(got[k], want[k]) for k in OUTPUTS) > 1e-2
    with torch.no_grad():
        r = ref.forward(weights, cfg, imgs, fault="frame_only_global")
    for k in OUTPUTS:
        assert gap(got[k], r[k]) < TOL, k


def test_one_frame_global_attention_is_frame_attention(tiny):
    cfg, weights, _, _ = tiny
    blk = program(cfg, weights).model.aggregator.global_blocks[0]
    x = torch.randn(1, 25, 128, generator=torch.Generator().manual_seed(1))
    pos = positions_with_special_tokens(4, 5, 5)[None]
    rope = make_rope_tables(pos, 64)
    assert torch.equal(V.global_block(blk, x, rope, 2),
                       L.encoder_block(blk, x, rope, 2))


# -- mechanisms ------------------------------------------------------------

def test_special_tokens_rope_is_the_identity():
    pos = positions_with_special_tokens(3, 4, 5)
    assert pos[:5].eq(0).all()
    assert torch.equal(pos[5:7], torch.tensor([[1, 1], [1, 2]],
                                              dtype=torch.int32))
    assert torch.equal(pos[-1], torch.tensor([3, 4], dtype=torch.int32))
    t = torch.randn(1, 17, 2, 64)
    cos, sin = make_rope_tables(pos[None], 64)
    out = apply_rope2d(t, cos, sin)
    assert torch.equal(out[:, :5], t[:, :5])
    assert not torch.allclose(out[:, 5:], t[:, 5:])


def test_resized_position_embedding_is_bicubic_antialias(tiny):
    cfg, weights, _, _ = tiny
    tower = program(cfg, weights).model.aggregator.patch_embed
    got = V.resized_pos_embed(tower, 4, 5)
    pe = weights["aggregator.patch_embed.pos_embed"]
    grid = pe[:, 1:].reshape(1, 5, 5, 128).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=(4, 5), mode="bicubic", antialias=True)
    assert torch.equal(got[:, 1:], want.permute(0, 2, 3, 1).reshape(1, 20,
                                                                   128))
    assert torch.equal(got[:, :1], pe[:, :1])
    # the learned square itself is used as it is, and made once
    assert torch.equal(V.resized_pos_embed(tower, 5, 5), pe)
    assert V.resized_pos_embed(tower, 4, 5) is V.resized_pos_embed(tower,
                                                                   4, 5)


def test_pose_encoding_to_cameras():
    from must3r_tpu_torch.ops.pose import pose_encoding_to_cameras
    enc = torch.tensor([[0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 2.0, 1.0, 1.2]])
    c2w, focal = pose_encoding_to_cameras(enc, (392, 518))
    assert torch.allclose(c2w[0, :3, :3], torch.eye(3))
    assert torch.allclose(c2w[0, :3, 3], -enc[0, :3])
    assert torch.allclose(focal[0], torch.tensor(
        [259 / np.tan(0.6), 196 / np.tan(0.5)], dtype=torch.float32))
    # a quarter turn about z (quaternion scalar last, unnormalised)
    enc = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]])
    c2w, _ = pose_encoding_to_cameras(enc, (10, 10))
    w2c = torch.linalg.inv(c2w[0])
    assert torch.allclose(w2c[:3, :3], torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]), atol=1e-6)
    assert torch.allclose(w2c[:3, 3], torch.tensor([1.0, 0.0, 0.0]))


def test_pose_encoding_to_cameras_matches_the_reference():
    """The program's cameras against the reference's reading of VGGT's
    pose_encoding_to_extri_intri, on random encodings (unnormalised
    quaternions, fields of view in (0.2, 2.5))."""
    from must3r_tpu_torch.ops.pose import pose_encoding_to_cameras
    gen = torch.Generator().manual_seed(5)
    enc = torch.randn(32, 9, generator=gen)
    enc[:, 7:] = 0.2 + 2.3 * torch.rand(32, 2, generator=gen)
    c2w, focal = pose_encoding_to_cameras(enc, (392, 518))
    want = ref.cameras(enc, (392, 518))
    assert gap(c2w, want["c2w"]) < 1e-6
    assert gap(focal, want["focal"]) < 1e-6


# -- the shared block functions with the new options off ------------------

def _old_self_attn(p, x, rope, num_heads, impl):
    q, k, v = L.linear(p.qkv, x).chunk(3, dim=-1)
    q, k, v = (L.split_heads(t, num_heads) for t in (q, k, v))
    if rope is not None:
        q = apply_rope2d(q, *rope)
        k = apply_rope2d(k, *rope)
    o = tatt.self_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            impl=impl)
    return L.linear(p.proj, L.merge_heads(o))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_blocks_without_the_options_are_unchanged(dtype):
    """MUSt3R's encoder block, self-attention and LayerNorm, bit for bit
    the formulas they had before the options."""
    gen = torch.Generator().manual_seed(3)
    blk = L.EncoderBlock(128, 4.0, 1e-6)
    L.init_module_(blk, gen)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    blk = blk.to(dtype)
    x = torch.randn(2, 20, 128, generator=gen).to(dtype)
    rope = make_rope_tables(positions_with_special_tokens(4, 4, 4)[None]
                            .expand(2, -1, -1), 64)
    old = x + _old_self_attn(blk.attn, L.layer_norm(blk.norm1, x), rope, 2,
                             None)
    old = old + L.mlp(blk.mlp, L.layer_norm(blk.norm2, old))
    assert torch.equal(L.encoder_block(blk, x, rope, 2), old)
    assert torch.equal(L.self_attn(blk.attn, x, rope, 2),
                       _old_self_attn(blk.attn, x, rope, 2, None))
    assert not hasattr(blk, "ls1") and not hasattr(blk.attn, "q_norm")


# -- weights, checkpoints, entries ----------------------------------------

def test_config_json_round_trip():
    for cfg in (vggt_1b_config(), program_cfg(tiny_cfg_dict())):
        back = config_from_json(config_to_json(cfg))
        assert back == cfg and isinstance(back, VGGTConfig)
    full = vggt_1b_config()
    assert (full.embed_dim, full.num_heads, full.head_dim, full.depth,
            full.tower_depth, full.camera_dim) == (1024, 16, 64, 24, 24, 2048)


def test_program_config_of_the_benchmark_file_is_the_preset():
    with open(ROOT / "benchmark" / "configs" / "vggt_1b.json") as f:
        assert program_cfg(json.load(f)) == vggt_1b_config()


def test_published_key_names_load_and_round_trip(tiny, tmp_path):
    """The benchmark's weights (published key names) load strictly, a
    published file's track head is dropped, and save / load gives the
    same state dict and config."""
    cfg, weights, imgs, _ = tiny
    model = load_vggt({**weights, "track_head.x.weight": torch.ones(2)},
                      program_cfg(cfg), "cpu")
    assert set(model.state_dict()) == set(weights)
    with pytest.raises(RuntimeError):
        load_vggt({k: v for k, v in weights.items()
                   if "q_norm" not in k}, program_cfg(cfg), "cpu")
    path = str(tmp_path / "tiny.pt")
    save_vggt_checkpoint(path, model)
    back = load_vggt_checkpoint(path, device="cpu")
    assert back.cfg == model.cfg
    sd = back.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in weights.items())
    torch.save(dict(weights), tmp_path / "bare.pt")
    bare = load_vggt_checkpoint(str(tmp_path / "bare.pt"), device="cpu",
                                cfg=model.cfg)
    assert all(torch.equal(bare.state_dict()[k], v)
               for k, v in weights.items())


def test_init_vggt_has_no_empty_leaf():
    from must3r_tpu_torch.checkpoint import init_vggt
    cfg = program_cfg(tiny_cfg_dict())
    model = init_vggt(cfg, seed=1, device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert float(model.aggregator.frame_blocks[0].ls1.gamma[0]) == \
        pytest.approx(0.01)
    assert float(model.aggregator.patch_embed.blocks[0].ls1.gamma[0]) == 1.0


def test_host_entry_matches_the_device_entry(tiny):
    from must3r_tpu_torch.demo.inference import (vggt_inference,
                                                 vggt_scene_state)
    from must3r_tpu_torch.ops import transfer
    cfg, weights, imgs, _ = tiny
    core = program(cfg, weights)
    want = vggt_reconstruction(core, imgs)
    frames = list(imgs.numpy())
    transfer.reset_moved_bytes()
    got = vggt_inference(core, frames)
    assert set(got) == set(want)
    for k, v in want.items():
        assert isinstance(got[k], np.ndarray)
        assert np.array_equal(got[k], v.numpy()), k
    scene = vggt_scene_state(frames, got)
    assert scene.pts3d.shape == (3, *HW, 3) and scene.focals.shape == (3,)
    # the camera-frame points of the depth lie on each pixel's ray
    z = got["depth"][..., 0]
    assert np.allclose(scene.pts3d_local[..., 2], z)
    assert np.allclose(scene.pts3d_local[0, 0, 0, 0],
                       -HW[1] / 2 / got["focal"][0, 0] * z[0, 0, 0])


def test_cli_reconstruct_vggt_preset(tiny, tmp_path):
    """``--preset vggt_1b`` on a folder of images with a tiny checkpoint:
    the frames cropped to the model's patch grid, one scene out."""
    import PIL.Image
    from must3r_tpu_torch.cli import reconstruct
    cfg, weights, _, _ = tiny
    ckpt = str(tmp_path / "tiny.pt")
    save_vggt_checkpoint(ckpt, load_vggt(weights, program_cfg(cfg), "cpu"))
    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        PIL.Image.fromarray(rng.integers(0, 255, (90, 120, 3), np.uint8)
                            ).save(folder / f"{i}.png")
    out = tmp_path / "out"
    reconstruct.main(["--preset", "vggt_1b", "--chkpt", ckpt, "--input",
                      str(folder), "--output_dir", str(out), "--device",
                      "cpu", "--amp", "fp32", "--image_size", "70"])
    import pickle
    with open(out / "scene.pkl", "rb") as f:
        scene = pickle.load(f)
    # 120 x 90 resized to 70 wide: 52.5 high, the nearest multiple of 14
    assert scene.pts3d.shape == (3, 56, 70, 3)
    assert (out / "scene_conf1.5.glb").exists()


def test_benchmark_weights_keep_every_leaf_off_zero(tiny):
    cfg, weights, _, _ = tiny
    assert all(bool(v.ne(0).all()) for v in weights.values())
    ls = weights["aggregator.frame_blocks.0.ls1.gamma"]
    assert 0.005 <= float(ls.min()) and float(ls.max()) <= 0.015
    again = make_weights(copy.deepcopy(cfg), SEED, "cpu")
    assert all(torch.equal(again[k], v) for k, v in weights.items())


# -- K1 at VGGT's shapes, on the card --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 66624), (64, 1041)])
def test_sa_kernel_matches_plain_at_vggt_shapes(b, n):
    """Global attention (one sequence of 64 x 1041 tokens) and frame
    attention (64 ragged sequences of 1041), 16 heads of 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernel K1)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, n, 16, 64, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    tatt.reset_launch_counts()
    got = tatt.self_attention(q, k, v)
    assert tatt.launch_counts()["sa_fwd"] == 1
    want = tatt.self_attention(q, k, v, impl="plain")
    e = kernel_error(got, want)
    assert e["ok"], e
