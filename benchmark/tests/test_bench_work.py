"""``work.py`` against counts worked by hand."""

import pytest

from benchmark import harness, work

CFG = harness.load_json(harness.ROOT / "benchmark/configs/must3r_512.json")


def test_one_10_view_512_collection():
    """Encoder: per token 24 x 2 x 12 d^2 (qkv, out, MLP of 4 d) + the patch
    embedding 2 x 768 x 1024, per image 24 x 4 N^2 d of attention; decoder
    per token and layer 2 x 14 d^2 (SA, CA q and out, MLP), memory writes 2
    x 2 d^2 (twice, the feedback rewrite, for 11 of 12 layers) and the
    feedback MLP 2 x 8 d^2; CA pairs: the first pair 2 N x N, view i attends
    i N keys (i = 2..9), render 10 N x 10 N; head 2 x 768 x 1792."""
    n, d, de = 768, 768, 1024
    enc = 10 * (n * (24 * 2 * 12 * de * de + 2 * 768 * de)
                + 24 * 4 * n * n * de)
    passes_update = 10 * n * (2 * de * d + 12 * 2 * 14 * d * d
                              + 12 * 4 * d * d + 11 * 4 * d * d
                              + 2 * 8 * d * d) + 10 * 12 * 4 * n * n * d
    passes_render = 10 * n * (2 * de * d + 12 * 2 * 14 * d * d) \
        + 10 * 12 * 4 * n * n * d
    pairs = 2 * n * n + sum(n * i * n for i in range(2, 10)) + (10 * n) ** 2
    ca = 12 * 4 * pairs * d
    head = 10 * n * 2 * d * 1792
    hand = enc + passes_update + passes_render + ca + head
    got = work.offline_request(CFG, (384, 512), 10, 10).flops
    assert got == pytest.approx(hand, rel=1e-12)
    assert got == pytest.approx(1.24e13, rel=0.01)


def test_kf50_render_attention():
    """Cell 3's render: 200 views x 768 queries against 50 x 768 keys, 12
    heads of 64, 12 layers: 4 * 153,600 * 38,400 * 64 * 12 * 12, bound by
    the products."""
    n = 768
    render = 4 * 153_600 * 38_400 * 64 * 12 * 12
    f, least = work.ca_call(CFG, 200 * n, 200 * n * 50 * n, 50 * n)
    assert 12 * f == render
    assert least == pytest.approx(f / work.PEAK_FLOPS)
    w = work.offline_request(CFG, (384, 512), 200, 50)
    assert w.ca_fwd_calls == 12 * 50
    assert w.ca_fwd_s > 12 * least


def test_training_step_and_dropout():
    """The causal pairs of the 224 recipe with dropout p: step 0 (5 images):
    image 0 attends 2 images, image i < 5 attends i images, none protected;
    later steps: image j attends j images, image 0's tokens kept whole."""
    cfg = harness.load_json(harness.ROOT / "benchmark/configs/must3r_224.json")
    n, p = 196, 0.1
    w = work.train_step(cfg, (224, 224), 1, (5, 5), 0, p)
    step0 = n * n * (1 - p) * (2 + 1 + 2 + 3 + 4)
    step1 = sum(n * (n + (j - 1) * n * (1 - p)) for j in range(5, 10))
    fwd = 4 * 64 * 12 * (step0 + step1)
    assert w.ca_fwd_calls == w.ca_bwd_calls == 24
    ca_flops = 12 * 3 * fwd
    rest = w.flops - ca_flops
    assert rest == pytest.approx(
        work.encoder_flops(cfg, 10, n)
        + 3 * (work.head_flops(cfg, 10, n)
               + work.decoder_pass_flops(cfg, 5, n, True) * 2), rel=1e-12)
