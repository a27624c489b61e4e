"""CUDA kernels of the PyTorch port against their plain PyTorch versions, on
the card, in bf16: K1 (sa_fwd), K2 (ca_fwd, serving and with LSE / dropout
mask), K3 (ca_bwd_dq), K4 (ca_bwd_dkv), K5 (ca_bwd_fused), K2(d)
(ca_fwd_q8, the 8-bit cache read), the fp8 probe kernels, K6 (ca_fwd_2h,
two heads per block) and K7 (ln_matmul, whose bound adds one bf16 ulp of
the output's largest value for the bf16 rounding of its normalised rows).
Kernel and plain version round P (and ds) to bf16 and differ only in
summation order, so the bounds scale with the reference: max abs error <=
min(0.05, 2e-2 * max|plain|) (0.05 is the bf16 P.V tolerance of the JAX
kernel tests) and relative RMSE <= 1e-2. The LSE is held to 1e-2 absolute:
it is m + log(l) of fp32 scores of bf16 inputs, |lse| ~ 5-10, and the two
sum the scores in another order (a few fp32 ulps of the products, far below
1e-2), while a wrong mask or scale moves it by O(1). K5 sums dq across key
tiles with fp32 atomics, whose order changes from run to run, so its dq is
held to the same bounds but not compared bit for bit between runs.

Every test is marked ``cuda`` and skips without a GPU. This file imports no
jax, so on a GPU machine without jax it runs on its own (the repo's conftest
imports jax):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -q
"""

import pytest
import torch

from must3r_tpu_torch.ops import attention as tatt
from must3r_tpu_torch.tools.parity import RMSE_REL, kernel_error

DH = 64
INT32_MAX = tatt.INT32_MAX
LSE_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (kernels K1 / K2)")
    return torch.device("cuda")


def _randn(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


def _disagreement(got, want):
    """(max abs error, its bound, relative RMSE) of a kernel vs plain."""
    e = kernel_error(got, want)
    return e["max_abs_err"], e["max_abs_bound"], e["rel_rmse"]


def _assert_matches_plain(got, want, ulp_allowance=False):
    assert torch.isfinite(got).all()
    e = kernel_error(got, want, ulp_allowance)
    assert e["ok"], e


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h", [
    (2, 196, 12), (1, 768, 16), (3, 65, 2), (1, 1, 1),
    # ragged N with images next to each other in memory (a tile past N must
    # not read the next image's rows), 12 and 16 heads, both block sizes:
    # 192 rows, with warpgroups wholly past N, for the first and third
    (12, 196, 12), (1, 65, 16), (17, 65, 16), (2, 196, 16)])
def test_sa_kernel_matches_plain(dev, b, n, h):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, dev, b, n, h, DH) for _ in range(3))
    tatt.reset_launch_counts()
    got = tatt.self_attention(q, k, v)              # impl=None: the kernel
    want = tatt.self_attention(q, k, v, impl="plain")
    assert tatt.launch_counts()["sa_fwd"] == 1
    _assert_matches_plain(got, want)


def _labels(dev, s, live, per_img):
    lab = torch.full((1, s), -1, dtype=torch.int32, device=dev)
    lab[0, :live] = torch.arange(live, dtype=torch.int32,
                                 device=dev) // per_img
    return lab


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,kv_len,q_self,q_upper", [
    (1, 100, 170, [1], [INT32_MAX]),              # update, kv_len mid-tile
    (2, 96, 200, [0, 1], [INT32_MAX, INT32_MAX]),  # init pair
    (2, 50, 256, [3, -2], [INT32_MAX, 2]),         # causal upper bound
    (1, 300, 256, [-2], [INT32_MAX]),              # flattened render
])
def test_ca_kernel_matches_plain(dev, g, n, kv_len, q_self, q_upper):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, dev, 1, g, n, 2, DH)
    cache = _randn(gen, dev, 3, 1, 2, 256, 2 * DH)
    lab = _labels(dev, 256, kv_len, 50)
    qs = torch.tensor([q_self], dtype=torch.int32, device=dev)
    qu = torch.tensor([q_upper], dtype=torch.int32, device=dev)
    tatt.reset_launch_counts()
    got = tatt.memory_cross_attention(q, cache, lab, qs, qu, kv_len, layer=1)
    want = tatt.memory_cross_attention(q, cache, lab, qs, qu, kv_len,
                                       layer=1, impl="plain")
    assert tatt.launch_counts()["ca_fwd"] == 1
    _assert_matches_plain(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("wrong,q_self", [("scaled_0.7", 9),
                                          ("ignores_q_self", 9),
                                          ("drops_last_9pct", -2)])
def test_tolerance_rejects_a_wrong_kernel_at_memory_shapes(dev, wrong,
                                                          q_self):
    """Against 7,680 random keys the outputs are ~0.1, so a fixed 0.05 bound
    would pass these wrong answers; the scaled bounds must not."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q = _randn(gen, dev, 1, 1, 768, 12, DH)
    cache = _randn(gen, dev, 1, 12, 8192, 2 * DH)
    lab = _labels(dev, 8192, 7680, 768)
    qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)

    def qs(v):
        return torch.full((1, 1), v, dtype=torch.int32, device=dev)

    want = tatt.memory_cross_attention(q, cache, lab, qs(q_self), qu, 7680,
                                       impl="plain")
    if wrong == "scaled_0.7":
        got = 0.7 * tatt.memory_cross_attention(q, cache, lab, qs(q_self),
                                                qu, 7680)
    elif wrong == "ignores_q_self":
        got = tatt.memory_cross_attention(q, cache, lab, qs(-2), qu, 7680)
    else:
        got = tatt.memory_cross_attention(q, cache, lab, qs(q_self), qu,
                                          6990)
    err, bound, rmse = _disagreement(got, want)
    print(f"{wrong}: max abs err {err:.3e} (bound {bound:.3e}), "
          f"relative RMSE {rmse:.3e} (bound {RMSE_REL})")
    assert not (err <= bound and rmse <= RMSE_REL)


@pytest.mark.cuda
def test_ca_kernel_never_reads_past_kv_len(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, dev, 1, 1, 64, 2, DH)
    cache = _randn(gen, dev, 1, 2, 256, 2 * DH)
    lab = _labels(dev, 256, 256, 64)
    qs = torch.full((1, 1), -2, dtype=torch.int32, device=dev)
    qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)
    a = tatt.memory_cross_attention(q, cache, lab, qs, qu, 100)
    cache[:, :, 100:] = float("nan")
    b = tatt.memory_cross_attention(q, cache, lab, qs, qu, 100)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [0, 128])
def test_ca_kernel_fully_masked_rows_are_zero(dev, kv_len):
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, dev, 1, 2, 40, 2, DH)
    cache = _randn(gen, dev, 1, 2, 256, 2 * DH)
    lab = torch.full((1, 256), -1, dtype=torch.int32, device=dev)
    lab[0, :128] = 7
    qs = torch.tensor([[7, -2]], dtype=torch.int32, device=dev)
    qu = torch.full((1, 2), INT32_MAX, dtype=torch.int32, device=dev)
    out = tatt.memory_cross_attention(q, cache, lab, qs, qu, kv_len)
    assert torch.isfinite(out).all()
    assert float(out[:, 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["fp32", "dh32", "noncontig"])
def test_kernel_wrappers_refuse_what_they_do_not_take(dev, bad):
    q = torch.zeros(1, 8, 2, DH, dtype=torch.bfloat16, device=dev)
    if bad == "fp32":
        q = q.float()
    elif bad == "dh32":
        q = q[..., :32].contiguous()
    else:
        q = torch.zeros(1, 2, 8, DH, dtype=torch.bfloat16,
                        device=dev).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        tatt.self_attention(q, q, q)


# ---------------------------------------------------------------------------
# The TMA + wgmma program of K1 and K2 (csrc/attention_sm90.cu) at its edges
# ---------------------------------------------------------------------------

def test_profile_groups_name_the_kernels_of_each_program():
    """The profile tools sum device time by kernel name: K1 and K2 run the
    TMA + wgmma program, K2(d) the WMMA one (runs on the CPU)."""
    from must3r_tpu_torch.tools.profile_offline import kernel_group

    for name, group in [
            ("void (anonymous namespace)::attn_fwd_sm90<false, false, false,"
             " 3>(CUtensorMap_st, ...)", "attn_fwd_sm90<false"),
            ("void (anonymous namespace)::attn_fwd_sm90<true, true, true, 1>"
             "(CUtensorMap_st, ...)", "attn_fwd_sm90<true"),
            ("void (anonymous namespace)::attn_fwd_kernel<64, false, false, 2>"
             "(...)", "attn_fwd_kernel<64"),
            ("nvjet_tss_192x192_64x4_2x1_v_bz_coopB_TNN", "matrix products"),
            ("void at::native::vectorized_elementwise_kernel<8, ...>",
             "other")]:
        assert kernel_group(name) == group, name


def _poison_past(kv, kv_len):
    """A copy of kv whose slots at or past kv_len hold NaN, +inf and -inf."""
    bad = kv.clone()
    tail = bad[:, :, kv_len:]
    tail[..., 0::3] = float("nan")
    tail[..., 1::3] = float("inf")
    tail[..., 2::3] = -float("inf")
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [0, 1, 63, 65, 1000])
def test_ca_sm90_slots_past_kv_len_change_nothing(dev, kv_len):
    """An 8,192-slot layer, every slot labelled: slots at or past kv_len hold
    NaN and +-inf, and the output and the LSE are bitwise those of the same
    call with the slots zeroed (the tensor map's key extent is kv_len), with
    and without STATS / EXT; and they match the plain version."""
    from must3r_tpu_torch.ops import _kernels

    gen = torch.Generator(device=dev).manual_seed(12)
    s_cap = 8192
    q = _randn(gen, dev, 1, 2, 100, 12, DH)
    kv = _randn(gen, dev, 1, 12, s_cap, 2 * DH)
    kv[:, :, kv_len:] = 0
    bad = _poison_past(kv, kv_len)
    lab = _labels(dev, s_cap, s_cap, 250)
    qs = torch.tensor([[1, -2]], dtype=torch.int32, device=dev)
    qu = torch.tensor([[INT32_MAX, 3]], dtype=torch.int32, device=dev)
    ext = torch.rand(1, 2, s_cap, generator=gen, device=dev) < 0.1
    for e in (None, ext):
        out, lse = _kernels.ca_fwd(q, kv, lab, qs, qu, kv_len, ext=e,
                                   return_stats=True)
        out2, lse2 = _kernels.ca_fwd(q, bad, lab, qs, qu, kv_len, ext=e,
                                     return_stats=True)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        if kv_len == 0:
            assert float(out.abs().max()) == 0.0
            assert bool((lse == tatt.EMPTY_LSE).all())
            continue
        want, want_lse = tatt._ca_plain(q, kv[..., :DH], kv[..., DH:], lab,
                                        qs, qu, kv_len, e, return_stats=True)
        _assert_matches_plain(out, want)
        assert float((lse - want_lse).abs().max()) <= LSE_TOL
    serving = _kernels.ca_fwd(q, bad, lab, qs, qu, kv_len)
    assert torch.equal(serving, _kernels.ca_fwd(q, kv, lab, qs, qu, kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,h,n", [(2, 1, 12, 150), (1, 2, 16, 150),
                                     (2, 1, 16, 1700), (1, 2, 12, 2000)])
@pytest.mark.parametrize("stats,ext_p", [(False, 0.0), (True, 0.15)])
def test_ca_sm90_per_image_masks(dev, b, g, h, n, stats, ext_p):
    """B * G = 2 images, each with its own q_self / q_upper (and, for B = 2,
    its own labels), 12 and 16 heads, STATS and EXT together, both block
    sizes (the last two cases run 192-row blocks); an image's own slots
    fill whole key tiles, which are skipped."""
    from must3r_tpu_torch.ops import _kernels

    gen = torch.Generator(device=dev).manual_seed(13)
    s_cap, kv_len = 1000, 900
    q = _randn(gen, dev, b, g, n, h, DH)
    kv = _randn(gen, dev, b, h, s_cap, 2 * DH)
    lab = torch.cat([_labels(dev, s_cap, kv_len, 128),
                     _labels(dev, s_cap, kv_len, 64)])[:b].contiguous()
    qs = torch.tensor([2, 5], dtype=torch.int32, device=dev).reshape(b, g)
    qu = torch.tensor([INT32_MAX, 6], dtype=torch.int32,
                      device=dev).reshape(b, g)
    ext = (torch.rand(b, g, s_cap, generator=gen, device=dev) < ext_p
           if ext_p else None)
    got = _kernels.ca_fwd(q, kv, lab, qs, qu, kv_len, ext=ext,
                          return_stats=stats)
    want = tatt._ca_plain(q, kv[..., :DH], kv[..., DH:], lab, qs, qu, kv_len,
                          ext, return_stats=stats)
    if stats:
        (got, lse), (want, want_lse) = got, want
        assert float((lse - want_lse).abs().max()) <= LSE_TOL
    _assert_matches_plain(got, want)


# ---------------------------------------------------------------------------
# Training variants: K2 with LSE / dropout mask, K3, K4, K5
# ---------------------------------------------------------------------------

def _train_case(dev, seed, b, g, n, s_cap, kv_len, q_self, q_upper, ext_p):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(gen, dev, b, g, n, 2, DH)
    kv = _randn(gen, dev, b, 2, s_cap, 2 * DH)
    lab = _labels(dev, s_cap, kv_len, max(n, 1)).expand(b, s_cap).contiguous()
    qs = torch.tensor([q_self] * b, dtype=torch.int32, device=dev)
    qu = torch.tensor([q_upper] * b, dtype=torch.int32, device=dev)
    ext = None
    if ext_p:
        ext = torch.rand(b, g, s_cap, generator=gen, device=dev) < ext_p
    dout = _randn(gen, dev, b, g, n, 2, DH)
    return q, kv, lab, qs, qu, kv_len, ext, dout


TRAIN_CASES = [
    # b, g, n, s_cap, kv_len, q_self, q_upper, ext_p
    (1, 1, 100, 256, 170, [2], [INT32_MAX], 0.0),       # update, mid-tile
    (2, 1, 96, 256, 256, [1], [1], 0.1),                # causal 1-view
    (1, 2, 96, 200, 192, [-2, 1], [2, 1], 0.1),         # init pair, ragged S
    (1, 5, 49, 320, 245, [5, 6, 7, 8, 9], [5, 6, 7, 8, 9], 0.1),  # 5 views
    (1, 1, 300, 256, 256, [-2], [INT32_MAX], 0.0),      # flattened render
]


def _plain_stats(q, kv, lab, qs, qu, kv_len, ext, dout):
    out, lse = tatt._ca_plain(q, kv[..., :DH], kv[..., DH:], lab, qs, qu,
                              kv_len, ext, return_stats=True)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 1, 3, 2)
    return out, lse, delta.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_ca_fwd_with_stats_and_mask_matches_plain(dev, case):
    from must3r_tpu_torch.ops import _kernels

    q, kv, lab, qs, qu, kv_len, ext, dout = _train_case(dev, 5, *case)
    want, want_lse, _ = _plain_stats(q, kv, lab, qs, qu, kv_len, ext, dout)
    got, lse = _kernels.ca_fwd(q, kv, lab, qs, qu, kv_len, ext=ext,
                               return_stats=True)
    _assert_matches_plain(got, want)
    assert float((lse - want_lse).abs().max()) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_ca_bwd_kernels_match_plain(dev, case):
    from must3r_tpu_torch.ops import _kernels

    q, kv, lab, qs, qu, kv_len, ext, dout = _train_case(dev, 6, *case)
    _, lse, delta = _plain_stats(q, kv, lab, qs, qu, kv_len, ext, dout)
    args = (q, kv, lab, qs, qu, kv_len, lse, delta, dout, ext)
    want_dq = tatt._ca_bwd_dq_plain(*args)
    want_dkv = tatt._ca_bwd_dkv_plain(*args)
    tatt.reset_launch_counts()
    _assert_matches_plain(_kernels.ca_bwd_dq(*args), want_dq)
    dkv = _kernels.ca_bwd_dkv(*args)
    _assert_matches_plain(dkv, want_dkv)
    if kv_len < kv.shape[2]:
        assert float(dkv[:, :, kv_len:].abs().max()) == 0.0
    dq5, dkv5 = _kernels.ca_bwd_fused(*args)
    _assert_matches_plain(dq5, want_dq)
    _assert_matches_plain(dkv5, want_dkv)
    counts = tatt.launch_counts()
    assert {k: counts[k] for k in ("sa_fwd", "ca_fwd", "ca_bwd_dq",
                                   "ca_bwd_dkv", "ca_bwd_fused")} == {
        "sa_fwd": 0, "ca_fwd": 0, "ca_bwd_dq": 1, "ca_bwd_dkv": 1,
        "ca_bwd_fused": 1}


@pytest.mark.cuda
def test_ca_bwd_kernels_empty_rows_and_dead_keys_are_zero(dev):
    """A query image that attends nothing gets dq = 0 and adds nothing to
    dK|dV; keys at or past kv_len get exactly 0."""
    from must3r_tpu_torch.ops import _kernels

    q, kv, lab, qs, qu, kv_len, ext, dout = _train_case(
        dev, 7, 1, 2, 70, 256, 130, [-2, -2], [INT32_MAX, INT32_MAX], 0.0)
    lab = torch.where(lab == 0, lab, torch.full_like(lab, -1)).contiguous()
    qs = torch.tensor([[-2, 0]], dtype=torch.int32, device=dev)  # image 1: none
    _, lse, _ = _plain_stats(q, kv, lab, qs, qu, kv_len, ext, dout)
    assert bool((lse[:, 1] == tatt.EMPTY_LSE).all())
    dout = dout.clone()
    dout[:, 0] = 0                          # gradient only into image 1
    delta = torch.zeros_like(lse)           # rowsum(dO * O): 0 for both
    args = (q, kv, lab, qs, qu, kv_len, lse, delta, dout, ext)
    dq5, dkv5 = _kernels.ca_bwd_fused(*args)
    for t in (_kernels.ca_bwd_dq(*args), dq5, _kernels.ca_bwd_dkv(*args),
              dkv5):
        assert torch.isfinite(t).all() and float(t.abs().max()) == 0.0
    # every key attended by image 0: dK|dV live up to kv_len, 0 past it
    _, lse, delta = _plain_stats(q, kv, lab, qs, qu, kv_len, ext,
                                 torch.flip(dout, [1]))
    dkv = _kernels.ca_bwd_dkv(q, kv, lab, qs, qu, kv_len, lse, delta,
                              torch.flip(dout, [1]), ext)
    assert float(dkv[:, :, 70:].abs().max()) == 0.0
    assert float(dkv[:, :, :70].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,fused", [(1, 96, False), (2, 96, True)])
def test_ca_function_on_cuda_launches_the_kernels(dev, g, n, fused):
    """Autograd through the CA on CUDA tensors: K2 with LSE forward, then
    K5 where the JAX routing folds, else K3 + K4; the gradients match the
    plain Function's."""
    q, kv, lab, qs, qu, kv_len, ext, dout = _train_case(
        dev, 9, 1, g, n, 256, 200, [-2] * g, [INT32_MAX] * g, 0.1)
    grads = {}
    for impl in (None, "plain"):
        qq, kk = q.clone().requires_grad_(), kv.clone().requires_grad_()
        tatt.reset_launch_counts()
        out = tatt.memory_cross_attention(qq, kk, lab, qs, qu, kv_len,
                                          extra_mask=ext, impl=impl)
        out.backward(dout)
        grads[impl] = (out.detach(), qq.grad, kk.grad, tatt.launch_counts())
    counts = grads[None][3]
    assert counts["ca_fwd"] == 1
    assert counts["ca_bwd_fused"] == int(fused)
    assert counts["ca_bwd_dq"] == counts["ca_bwd_dkv"] == int(not fused)
    assert not any(grads["plain"][3].values())
    for got, want in zip(grads[None][:3], grads["plain"][:3]):
        _assert_matches_plain(got, want)


# ---------------------------------------------------------------------------
# K2(d): the 8-bit cache read, and the fp8 probe kernels
# ---------------------------------------------------------------------------

Q8_FORMATS = [torch.int8, torch.float8_e4m3fn]


def _q8_cache(gen, dev, qdtype, depth, b, s_cap):
    """An 8-bit cache [L, B, 2, S, 2*Dh] quantized from bf16 tokens, with its
    scales [L, B, 2, 2, S]."""
    from must3r_tpu_torch.memory import quantize_kv
    return quantize_kv(_randn(gen, dev, depth, b, 2, s_cap, 2 * DH), qdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", Q8_FORMATS)
@pytest.mark.parametrize("g,n,kv_len,q_self,q_upper,ext_p,stats", [
    (1, 100, 170, [1], [INT32_MAX], 0.0, False),           # update
    (2, 96, 200, [0, 1], [INT32_MAX, INT32_MAX], 0.0, False),  # init pair
    (2, 50, 256, [3, -2], [INT32_MAX, 2], 0.1, False),     # causal + ext
    (1, 300, 256, [-2], [INT32_MAX], 0.0, False),          # render
    (2, 70, 190, [1, -2], [INT32_MAX, 3], 0.1, True),      # STATS + EXT
])
def test_ca_q8_kernel_matches_plain(dev, qdtype, g, n, kv_len, q_self,
                                    q_upper, ext_p, stats):
    gen = torch.Generator(device=dev).manual_seed(11)
    q = _randn(gen, dev, 1, g, n, 2, DH)
    codes, scale = _q8_cache(gen, dev, qdtype, 3, 1, 256)
    lab = _labels(dev, 256, kv_len, 50)
    qs = torch.tensor([q_self], dtype=torch.int32, device=dev)
    qu = torch.tensor([q_upper], dtype=torch.int32, device=dev)
    ext = (torch.rand(1, g, 256, generator=gen, device=dev) < ext_p
           if ext_p else None)
    if stats:
        from must3r_tpu_torch.ops import _kernels
        got, lse = _kernels.ca_fwd_q8(q, codes[1], scale[1], lab, qs, qu,
                                      kv_len, ext=ext, return_stats=True)
        want, want_lse = tatt._ca_q8_plain(q, codes[1], scale[1], lab, qs,
                                           qu, kv_len, ext,
                                           return_stats=True)
        assert float((lse - want_lse).abs().max()) <= LSE_TOL
    else:
        tatt.reset_launch_counts()
        got = tatt.memory_cross_attention(q, codes, lab, qs, qu, kv_len,
                                          extra_mask=ext, layer=1,
                                          kv_scale=scale)
        want = tatt.memory_cross_attention(q, codes, lab, qs, qu, kv_len,
                                           extra_mask=ext, layer=1,
                                           impl="plain", kv_scale=scale)
        counts = tatt.launch_counts()
        assert counts["ca_fwd_q8"] == 1 and counts["ca_fwd"] == 0
    _assert_matches_plain(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", Q8_FORMATS)
def test_ca_q8_kernel_never_reads_past_kv_len(dev, qdtype):
    """Slots at or past kv_len hold the largest codes and scales of 1e30:
    the output must not move."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q = _randn(gen, dev, 1, 1, 64, 2, DH)
    codes, scale = _q8_cache(gen, dev, qdtype, 1, 1, 256)
    lab = _labels(dev, 256, 256, 64)
    qs = torch.full((1, 1), -2, dtype=torch.int32, device=dev)
    qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)
    a = tatt.memory_cross_attention(q, codes, lab, qs, qu, 100, layer=0,
                                    kv_scale=scale)
    big = torch.tensor([127.0 if qdtype == torch.int8 else 448.0]).to(qdtype)
    codes.view(torch.uint8)[:, :, :, 100:] = int(big.view(torch.uint8))
    scale[..., 100:] = 1e30
    b = tatt.memory_cross_attention(q, codes, lab, qs, qu, 100, layer=0,
                                    kv_scale=scale)
    assert torch.isfinite(b).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", Q8_FORMATS)
@pytest.mark.parametrize("kv_len", [0, 128])
def test_ca_q8_kernel_fully_masked_rows_are_zero(dev, qdtype, kv_len):
    gen = torch.Generator(device=dev).manual_seed(13)
    q = _randn(gen, dev, 1, 2, 40, 2, DH)
    codes, scale = _q8_cache(gen, dev, qdtype, 1, 1, 256)
    lab = torch.full((1, 256), -1, dtype=torch.int32, device=dev)
    lab[0, :128] = 7
    qs = torch.tensor([[7, -2]], dtype=torch.int32, device=dev)
    qu = torch.full((1, 2), INT32_MAX, dtype=torch.int32, device=dev)
    out = tatt.memory_cross_attention(q, codes, lab, qs, qu, kv_len, layer=0,
                                      kv_scale=scale)
    assert torch.isfinite(out).all()
    assert float(out[:, 0].abs().max()) == 0.0


@pytest.mark.cuda
def test_fp8_probe_kernels_match_plain(dev):
    """The fp8 -> bf16 conversion is exact; the dequant dot is within fp32
    summation noise of the plain product."""
    from must3r_tpu_torch.tools import probe_fp8

    tatt.reset_launch_counts()
    r = probe_fp8.run(dev)
    assert r["conv_ok"] and r["dot_ok"], r
    counts = tatt.launch_counts()
    assert counts["fp8_to_bf16_x2"] == 1 and counts["fp8_dequant_dot"] == 1


# -- K6 (ca_fwd_2h) and K7 (ln_matmul), the microbenchmark kernels ----------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,s,kv_len", [
    (1, 100, 4, 256, 256),          # ragged query tail
    (2, 257, 2, 320, 200),          # kv_len inside a 64-key tile, B = 2
    (1, 768, 12, 1536, 1000),       # the update shape, partial fill
])
def test_ca_2h_kernel_matches_plain_and_k2(dev, b, n, h, s, kv_len):
    from must3r_tpu_torch.ops import bench_kernels as bk

    gen = torch.Generator(device=dev).manual_seed(n)
    q = _randn(gen, dev, b, 1, n, h, DH)
    kv = _randn(gen, dev, 3, b, h, s, 2 * DH)
    lab = torch.randint(-1, 3, (b, s), generator=gen, device=dev,
                        dtype=torch.int32)
    lab[:, kv_len:] = 5               # live labels past kv_len: never read
    tatt.reset_launch_counts()
    got = bk.memory_cross_attention_2h(q, kv, lab, kv_len, 2)
    assert tatt.launch_counts()["ca_fwd_2h"] == 1
    want = bk.memory_cross_attention_2h(q, kv, lab, kv_len, 2, impl="plain")
    _assert_matches_plain(got, want)
    qs = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    qu = torch.full((b, 1), INT32_MAX, dtype=torch.int32, device=dev)
    k2 = tatt.memory_cross_attention(q, kv, lab, qs, qu, kv_len, layer=2)
    _assert_matches_plain(got, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [0, 128])
def test_ca_2h_kernel_row_that_attends_nothing_is_zero(dev, kv_len):
    from must3r_tpu_torch.ops import bench_kernels as bk

    gen = torch.Generator(device=dev).manual_seed(17)
    q = _randn(gen, dev, 2, 1, 40, 2, DH)
    kv = _randn(gen, dev, 1, 2, 2, 256, 2 * DH)
    lab = torch.full((2, 256), -1, dtype=torch.int32, device=dev)
    lab[1, :100] = 0                  # batch element 1 attends, 0 does not
    out = bk.memory_cross_attention_2h(q, kv, lab, kv_len, 0)
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0
    assert (float(out[1].abs().max()) > 0) == (kv_len > 0)


def _ln_case(gen, dev, m, k, n):
    x = (torch.randn(m, k, generator=gen, device=dev) * 3 + 1
         ).to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)
         ).to(torch.bfloat16)
    b = (0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    w = (0.03 * torch.randn(k, n, generator=gen, device=dev)
         ).to(torch.bfloat16)
    return x, g, b, w


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 768, 2304), (980, 768, 3072),
                                   (1, 64, 128), (77, 1664, 256)])
def test_ln_matmul_kernel_matches_plain(dev, m, k, n):
    """Ragged M (980 = 5 x 196 unpadded, 1, 77) and the largest K. Bound:
    phase B's plus one bf16 ulp of the output's largest value (the
    normalised rows are rounded to bf16 in both)."""
    from must3r_tpu_torch.ops import bench_kernels as bk

    gen = torch.Generator(device=dev).manual_seed(m)
    x, g, b, w = _ln_case(gen, dev, m, k, n)
    tatt.reset_launch_counts()
    got = bk.ln_matmul(x, g, b, w)
    assert tatt.launch_counts()["ln_matmul"] == 1
    want = bk.ln_matmul(x, g, b, w, impl="plain")
    assert got.shape == (m, n) and torch.isfinite(got).all()
    _assert_matches_plain(got, want, ulp_allowance=True)
