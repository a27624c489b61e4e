"""The ``vggt_scene`` cell rehearsed on the CPU at the tiny size
(``tiny_vggt.py``) through ``harness.run_cell``, the harness's look for a
card skipped: a sound run comes out correct; each control of
``vggt_controls.py`` and each fault the cell can have, planted in the
program underneath the timed path, come out not correct; no module of JAX
or of the JAX package was loaded; the work and the new metrics' readers.

The tiny program runs in float32 here (the CPU emulates bf16 products
slowly and with other roundings than the card's): the cell's limits, set
from the card's bf16 runs, then hold the sound run by a wide margin, and
each control and fault still has to exceed one of them."""

import pytest
import torch

from benchmark import harness, vggt_controls
from benchmark.tests.tiny_vggt import tiny_vggt_cell
from benchmark.trace import Trace
from benchmark.vggt_work import VGGTWork, sa_call, vggt_request

SEED = 2 ** 31 + 1013


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell():
    c = tiny_vggt_cell()
    c.config["dtype"] = "float32"
    return c


def run(c, driver_cls=None):
    return harness.run_cell(c, SEED, 0.2, False, device="cpu",
                            driver_cls=driver_cls, log=lambda *a: None)


def test_sound_run_is_correct():
    result = run(cell())
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert set(result["checks"]) == {
        "world_points", "world_points_conf", "depth", "pose_enc",
        "heads_stage", "cameras_stage"}
    assert harness.forbidden_modules() == []


def test_cameras_in_bf16_are_seen_by_the_cameras_number():
    """The heads_bf16 control reads its cameras in bf16: the cameras'
    stage number fails, while the program's (float32) holds far under."""
    c = cell()
    sound = run(c)["checks"]["cameras_stage"]
    assert sound["value"] < sound["limit"] / 10
    bf16 = run(c, vggt_controls.control(c, "heads_bf16"))["checks"]
    assert bf16["cameras_stage"]["value"] > bf16["cameras_stage"]["limit"]


@pytest.mark.parametrize("ctl", vggt_controls.names(cell()))
def test_control_is_not_correct(ctl):
    c = cell()
    result = run(c, vggt_controls.control(c, ctl))
    assert not result["correct"], result["checks"]


def test_first_frame_fault_is_not_correct(monkeypatch):
    """Frame 0 given the others' camera and register tokens."""
    from must3r_tpu_torch.engine import inference
    real = inference.VGGTCore.__init__

    def init(self, model, *a, **k):
        with torch.no_grad():
            agg = model.aggregator
            agg.camera_token[:, 0] = agg.camera_token[:, 1]
            agg.register_token[:, 0] = agg.register_token[:, 1]
        real(self, model, *a, **k)
    monkeypatch.setattr(inference.VGGTCore, "__init__", init)
    result = run(cell())
    assert not result["correct"], result["checks"]


def test_global_attention_cut_to_frames_is_not_correct(monkeypatch):
    from must3r_tpu_torch.models import layers, vggt

    def frame_only(p, x, rope, num_heads, *a, **k):
        # the frame's RoPE tables are the first P rows of the scene's
        return layers.encoder_block(p, x, tuple(t[:, :x.shape[1]]
                                                for t in rope),
                                    num_heads, *a, **k)
    monkeypatch.setattr(vggt, "global_block", frame_only)
    result = run(cell())
    assert not result["correct"], result["checks"]


def test_heads_altered_are_seen_by_the_stage_number(monkeypatch):
    """A DPT head's output altered where it is produced: the heads' stage
    number fails."""
    from must3r_tpu_torch.models import vggt
    real = vggt._dpt_chunk

    def chunk(*a, **k):
        out = real(*a, **k)
        return out * 1.05
    monkeypatch.setattr(vggt, "_dpt_chunk", chunk)
    result = run(cell())
    assert result["checks"]["heads_stage"]["value"] > \
        result["checks"]["heads_stage"]["limit"]
    assert not result["correct"]


def test_work_of_a_request_by_hand():
    """The full cell's request: 64 frames of 1,041 tokens; the global
    attention 4 x 1024 x (64 x 1041)^2 per layer; K1 calls 24 tower + 24
    frame + 24 global."""
    c = harness.load_cell("vggt1b_s64_518")
    w = vggt_request(c.config, (392, 518), 64)
    assert w.sa_calls == 72
    f, s = sa_call(1, 64 * 1041, 1024)
    assert f == 4 * (64 * 1041) ** 2 * 1024
    assert s == pytest.approx(f / 989e12)
    assert 590e12 < w.flops < 610e12
    glob = 24 * f
    assert 0.70 < glob / w.flops < 0.76
    assert w.scaled(2).sa_s == pytest.approx(2 * w.sa_s)
    assert isinstance(w.scaled(2), VGGTWork)


def test_new_readers():
    """sa_roofline: least time over K1's device time; dpt_share: the union
    of convolution and resampling kernels over the busy time; neither
    reads where there is nothing to read."""
    sa = harness.metric_reader("sa_roofline.offline")
    dpt = harness.metric_reader("dpt_share.offline")
    tr = Trace(device=[(0, 400, "void attn_fwd_sm90<false, false, 0>"),
                       (400, 500, "sm90_xmma_fprop_implicit_gemm_tf32"),
                       (450, 600, "upsample_bilinear2d_out_frame"),
                       (600, 1000, "sm90_xmma_gemm_bf16bf16")],
               host=[], t0_ns=0, t1_ns=2000)
    ctx = harness.Context(cell=None, setup_s=0, window_s=2e-6, requests=1,
                          units=64, work=VGGTWork(sa_s=2e-7), peak_bytes=0,
                          trace=tr)
    assert sa(ctx) == pytest.approx(50.0)
    assert dpt(ctx) == pytest.approx(20.0)
    ctx.work = VGGTWork()
    assert sa(ctx) is None
    ctx.trace = None
    assert dpt(ctx) is None
