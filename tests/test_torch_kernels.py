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
blocks with fp32 reduce-adds, whose order changes from run to run, so its
dq is held to the same bounds but not compared bit for bit between runs.

Every kernel test is marked ``cuda`` and skips without a GPU; the tests of
the profilers' and the variant builds' helpers run on the CPU. This file
imports no
jax, so on a GPU machine without jax it runs on its own (the repo's conftest
imports jax):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -q
"""

import pytest
import torch

from must3r_tpu_torch.ops import attention as tatt
from must3r_tpu_torch.tools import ablate_kernels
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

def test_every_bound_entry_is_defined_with_its_arguments():
    """Each C entry that ``_kernels._load`` binds (``ENTRIES``) is defined in
    the ``extern "C"`` block of its source in ``SOURCES``, with one parameter
    for each of its argtypes, a pointer where a pointer is declared and an
    int where an int is; the blocks define nothing else (runs on the CPU: a
    stale binding would otherwise show only on the card)."""
    import ctypes
    import re

    from must3r_tpu_torch.ops import _kernels

    assert sorted(src.stem for src in _kernels.SOURCES) == \
        sorted(_kernels.ENTRIES)
    for src in _kernels.SOURCES:
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text,
                            re.S)
        assert len(blocks) == 1, src.name
        defined = {
            name: ["ptr" if "*" in p else p.split()[0]
                   for p in params.split(",")]
            for name, params in re.findall(r"\bint (\w+)\(([^)]*)\)\s*\{",
                                           blocks[0])}
        want = {name: ["ptr" if t is ctypes.c_void_p else "int"
                       for t in types]
                for name, types in _kernels.ENTRIES[src.stem].items()}
        assert defined == want, src.name


def test_profile_groups_name_the_kernels_of_each_program():
    """The profile tools sum device time by kernel name: K1, K2 and K2(d)
    (int8, fp8) run the TMA + wgmma forward program, K5 and K4 (its DQ =
    false) the key-block backward, K3 the query-block backward, K6 the WMMA
    program (runs on the CPU)."""
    from must3r_tpu_torch.tools.profile_offline import kernel_group

    fwd = "void (anonymous namespace)::attn_fwd_sm90<{}>(CUtensorMap_st, ...)"
    for name, group in [
            (fwd.format("false, false, false, 0, 3"), "attn_fwd_sm90<false"),
            (fwd.format("true, true, true, 0, 1"), "attn_fwd_sm90<true"),
            (fwd.format("true, false, false, 1, 3"), "attn_fwd_sm90 q8 int8"),
            (fwd.format("true, true, true, 2, 1"), "attn_fwd_sm90 q8 fp8"),
            ("void (anonymous namespace)::ca_bwd_fused_sm90<true, true>"
             "(CUtensorMap_st, ...)", "ca_bwd_fused_sm90"),
            ("void (anonymous namespace)::ca_bwd_fused_sm90<false, false>"
             "(CUtensorMap_st, ...)", "ca_bwd_fused_sm90 dkv"),
            ("void (anonymous namespace)::ca_bwd_dq_sm90<true, 3>"
             "(CUtensorMap_st, ...)", "ca_bwd_dq_sm90"),
            ("void (anonymous namespace)::ca_fwd_2h_kernel<64>(...)",
             "ca_fwd_2h_kernel"),
            ("nvjet_tss_192x192_64x4_2x1_v_bz_coopB_TNN", "matrix products"),
            ("void at::native::vectorized_elementwise_kernel<8, ...>",
             "other")]:
        assert kernel_group(name) == group, name


@pytest.mark.parametrize("per_call", [1.0, 10.0])
def test_profile_train_alternating_pairs_median(per_call):
    """The rate of profile_train (steps/s, 1 a call) and profile_offline
    (views/s, 10 a request): rounds in turns (kernel first in even rounds,
    plain first in odd ones), each call timed alone, medians and quartiles
    of the rates, and the median of the per-round ratio (runs on the CPU
    with a fake clock)."""
    from must3r_tpu_torch.tools import profile_train
    from must3r_tpu_torch.tools.profile_offline import alternating_pairs

    assert profile_train.alternating_pairs is alternating_pairs

    now = [0.0]
    order = []
    durations = {"kernel": iter([0.5, 0.25, 1.0, 0.5, 0.5]),
                 "plain": iter([1.0, 1.0, 2.0, 1.0, 4.0])}

    def run(name):
        def go():
            order.append(name)
            now[0] += next(durations[name])
        return go

    syncs = []
    out = alternating_pairs({"kernel": run("kernel"), "plain": run("plain")},
                            5, per_call=per_call,
                            sync=lambda: syncs.append(1),
                            clock=lambda: now[0])
    assert order == ["kernel", "plain", "plain", "kernel", "kernel",
                     "plain", "plain", "kernel", "kernel", "plain"]
    assert len(syncs) == 20                   # before and after each call
    k, p = out["kernel"], out["plain"]
    assert k["per_s_median"] == 2.0 * per_call
    assert p["per_s_median"] == 1.0 * per_call
    assert (k["min"], k["max"]) == (1.0 * per_call, 4.0 * per_call)
    assert (p["min"], p["max"]) == (0.25 * per_call, 1.0 * per_call)
    assert k["host_ms_median"] == 500.0 and p["host_ms_median"] == 1000.0
    assert k["q1"] <= k["per_s_median"] <= k["q3"]
    # per-round plain / kernel time: 2, 4, 2, 2, 8
    assert out["kernel_over_plain_median"] == 2.0


@pytest.mark.parametrize("name", list(ablate_kernels.VARIANTS))
def test_ablate_variants_apply_to_the_sources(name):
    """Each variant build of tools/ablate_kernels.py finds every text it
    edits exactly once in today's kernel source (it raises otherwise), and
    the unchanged variants are the sources themselves."""
    from must3r_tpu_torch.ops import _kernels

    stem, off, edits = ablate_kernels.VARIANTS[name]
    src = (_kernels._CSRC / f"{stem}.cu").read_text()
    text = ablate_kernels.variant_source(name)
    assert (text == src) == (not edits) and off
    for old, new in edits:
        assert new in text


def test_ablate_ptxas_report_reads_registers_and_spills():
    REPORTED, ptxas_report = (ablate_kernels.REPORTED,
                              ablate_kernels.ptxas_report)
    log = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__d3_17_attention_sm90_cu_ee13attn_fwd_sm90ILb1ELb0ELb0ELi1ELi3EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__d3_17_attention_sm90_cu_ee13attn_fwd_sm90ILb1ELb0ELb0ELi1ELi3EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__d3_17_attention_sm90_cu_ee13attn_fwd_sm90ILb1ELb1ELb0ELi0ELi1EEEv14CUtensorMap_st' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__b2_21_attention_bwd_sm90_cu_68017ca_bwd_fused_sm90ILb1ELb1EEEv14CUtensorMap_st' for 'sm_90a'
    40 bytes stack frame, 48 bytes spill stores, 84 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__b2_21_attention_bwd_sm90_cu_68017ca_bwd_dq_sm90ILb0ELi1EEEv14CUtensorMap_st' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""
    got = ptxas_report(log, lambda k: k.startswith(REPORTED))
    assert got == {
        "attn_fwd_sm90<1, 0, 0, 1, 3>": dict(spill_stores=0, spill_loads=0,
                                             registers=128),
        "ca_bwd_fused_sm90<1, 1>": dict(spill_stores=48, spill_loads=84,
                                        registers=168),
        "ca_bwd_dq_sm90<0, 1>": dict(spill_stores=0, spill_loads=0,
                                     registers=128)}
    assert len(ptxas_report(log)) == 4


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
    # the edges of K3 / K4's tiling: G = 2 at N > 1,024 (no fold, so K3 + K4
    # run with G > 1), kv_len = S off the 64 / 128 grid, a ragged kv_len
    # with a dense dropout mask (kv_len 0: the slots-past-kv_len test)
    (1, 2, 1100, 2400, 2300, [0, -2], [INT32_MAX, 1], 0.1),
    (2, 1, 130, 200, 200, [1], [INT32_MAX], 0.1),
    (1, 1, 64, 384, 321, [-2], [INT32_MAX], 0.3),
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
@pytest.mark.parametrize("kv_len", [0, 1, 63, 65, 130, 1000])
def test_ca_bwd_dq_dkv_slots_past_kv_len_change_nothing(dev, kv_len):
    """A 1,100-slot layer, every slot labelled: slots at or past kv_len
    hold NaN and 1e30, and K3's dq and K4's dK|dV are bitwise those of the
    same call with the slots zeroed (both kernels sum in a fixed order), with
    and without a dropout mask; dK|dV is exactly 0 past kv_len, and both
    match their plain versions (an output whose plain version is 0 must be
    exactly 0, as with kv_len 0). With one key (kv_len 1) p = 1 and ds =
    dO.v - delta = 0 in exact arithmetic, so dq and dk are rounding noise of
    a cancellation and only dv is held to the plain version there."""
    from must3r_tpu_torch.ops import _kernels

    gen = torch.Generator(device=dev).manual_seed(26)
    s_cap = 1100
    q = _randn(gen, dev, 1, 1, 150, 12, DH)
    dout = _randn(gen, dev, 1, 1, 150, 12, DH)
    kv = _randn(gen, dev, 1, 12, s_cap, 2 * DH)
    kv[:, :, kv_len:] = 0
    bad = kv.clone()
    bad[:, :, kv_len:, 0::2] = float("nan")
    bad[:, :, kv_len:, 1::2] = 1e30
    lab = _labels(dev, s_cap, s_cap, 250)
    qs = torch.tensor([[1]], dtype=torch.int32, device=dev)
    qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)
    ext = torch.rand(1, 1, s_cap, generator=gen, device=dev) < 0.1
    for e in (None, ext):
        _, lse, delta = _plain_stats(q, kv, lab, qs, qu, kv_len, e, dout)
        args = [q, kv, lab, qs, qu, kv_len, lse, delta, dout, e]
        dq, dkv = _kernels.ca_bwd_dq(*args), _kernels.ca_bwd_dkv(*args)
        args[1] = bad
        assert torch.equal(dq, _kernels.ca_bwd_dq(*args))
        assert torch.equal(dkv, _kernels.ca_bwd_dkv(*args))
        assert float(dkv[:, :, kv_len:].abs().max()) == 0.0
        args[1] = kv
        pairs = [(dkv[..., DH:], tatt._ca_bwd_dkv_plain(*args)[..., DH:])]
        if kv_len != 1:
            pairs += [(dq, tatt._ca_bwd_dq_plain(*args)),
                      (dkv, tatt._ca_bwd_dkv_plain(*args))]
        for got, want in pairs:
            if float(want.abs().max()) == 0.0:
                assert float(got.abs().max()) == 0.0
            else:
                _assert_matches_plain(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,fused", [(1, 96, False), (2, 96, True),
                                       (1, 130, False), (2, 1100, False)])
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


# ---------------------------------------------------------------------------
# K2(d) on the TMA + wgmma program, and K5 as a wgmma program, at the main
# path's shapes and edges
# ---------------------------------------------------------------------------

def _memory_labels(dev, s_cap, live, per_img):
    """[1, s_cap] labels of a memory of live // per_img images."""
    return _labels(dev, s_cap, live, per_img)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", Q8_FORMATS)
@pytest.mark.parametrize("case", [
    # name, heads, n, q_self: the render with 192-row blocks (12 heads) and
    # with 64-row blocks (2 heads); the update, whose own image's 12 key
    # tiles are skipped (the ring must not deadlock on them)
    ("render_nc3", 12, 7680, -2), ("render_nc1", 2, 7680, -2),
    ("update", 12, 768, 9)])
def test_ca_q8_sm90_matches_plain_at_main_path_shapes(dev, qdtype, case):
    """K2(d) against its plain version against a 10-view memory (7,680 live
    slots of 8,192), with the launch counted once."""
    from must3r_tpu_torch.ops import _kernels

    _, heads, n, q_self = case
    gen = torch.Generator(device=dev).manual_seed(21)
    q = _randn(gen, dev, 1, 1, n, heads, DH)
    from must3r_tpu_torch.memory import quantize_kv
    codes, scale = quantize_kv(_randn(gen, dev, 1, 1, heads, 8192, 2 * DH),
                               qdtype)
    lab = _memory_labels(dev, 8192, 7680, 768)
    qs = torch.full((1, 1), q_self, dtype=torch.int32, device=dev)
    qu = torch.full((1, 1), INT32_MAX, dtype=torch.int32, device=dev)
    tatt.reset_launch_counts()
    got = _kernels.ca_fwd_q8(q, codes[0], scale[0], lab, qs, qu, 7680)
    assert tatt.launch_counts()["ca_fwd_q8"] == 1
    want = tatt._ca_q8_plain(q, codes[0], scale[0], lab, qs, qu, 7680)
    _assert_matches_plain(got, want)


def _poison_q8(codes, scale, slots, qdtype):
    """Copies of codes / scales whose ``slots`` (a bool [S] mask) hold NaN
    codes (fp8) or the extreme codes (int8), and NaN, +inf and 1e30
    scales."""
    bad_c, bad_s = codes.clone(), scale.clone()
    raw = bad_c.view(torch.uint8)
    idx = slots.nonzero().flatten()
    if qdtype == torch.int8:
        raw[:, :, idx, 0::2] = 127
        raw[:, :, idx, 1::2] = 128                # -128
    else:
        raw[:, :, idx] = 0x7F                     # e4m3 NaN
    for k, v in enumerate((float("nan"), float("inf"), 1e30)):
        sel = idx[k::3]
        bad_s[..., sel] = v
    return bad_c, bad_s


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", Q8_FORMATS)
@pytest.mark.parametrize("kv_len", [0, 1, 63, 65, 1000])
def test_ca_q8_sm90_masked_and_past_kv_len_slots_change_nothing(dev, qdtype,
                                                                 kv_len):
    """An 8,192-slot layer: the slots at or past kv_len and the slots that
    the step's masks block (an image's own label, q_upper, the dropout mask)
    hold NaN / extreme codes and NaN / inf / 1e30 scales, and the output and
    the LSE are bitwise those of the clean call, with and without STATS /
    EXT; they match the plain version."""
    from must3r_tpu_torch.memory import quantize_kv
    from must3r_tpu_torch.ops import _kernels

    gen = torch.Generator(device=dev).manual_seed(22)
    s_cap = 8192
    q = _randn(gen, dev, 1, 2, 100, 12, DH)
    codes, scale = quantize_kv(_randn(gen, dev, 1, 12, s_cap, 2 * DH), qdtype)
    lab = _labels(dev, s_cap, s_cap, 250)
    qs = torch.tensor([[1, -2]], dtype=torch.int32, device=dev)
    qu = torch.tensor([[INT32_MAX, 3]], dtype=torch.int32, device=dev)
    ext = torch.rand(1, 2, s_cap, generator=gen, device=dev) < 0.1
    slot = torch.arange(s_cap, device=dev)
    # blocked for both images: past kv_len, or label 1 with the dropout
    # mask of image 1 (image 0 skips label 1, image 1 everything >= 3)
    blocked = (slot >= kv_len) | ((lab[0] == 1) & ext[0, 1])
    bad_c, bad_s = _poison_q8(codes, scale, blocked, qdtype)
    for e in (None, ext):
        if e is None:
            # without ext, only slots past kv_len are blocked for both
            bc, bs = _poison_q8(codes, scale, slot >= kv_len, qdtype)
        else:
            bc, bs = bad_c, bad_s
        out, lse = _kernels.ca_fwd_q8(q, codes, scale, lab, qs, qu, kv_len,
                                      ext=e, return_stats=True)
        out2, lse2 = _kernels.ca_fwd_q8(q, bc, bs, lab, qs, qu, kv_len,
                                        ext=e, return_stats=True)
        assert torch.isfinite(out2).all()
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        if kv_len == 0:
            assert float(out.abs().max()) == 0.0
            assert bool((lse == tatt.EMPTY_LSE).all())
            continue
        want, want_lse = tatt._ca_q8_plain(q, codes, scale, lab, qs, qu,
                                           kv_len, e, return_stats=True)
        _assert_matches_plain(out, want)
        assert float((lse - want_lse).abs().max()) <= LSE_TOL
    bc, bs = _poison_q8(codes, scale, slot >= kv_len, qdtype)
    assert torch.equal(_kernels.ca_fwd_q8(q, bc, bs, lab, qs, qu, kv_len),
                       _kernels.ca_fwd_q8(q, codes, scale, lab, qs, qu,
                                          kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", Q8_FORMATS)
def test_ca_q8_sm90_row_that_attends_nothing_is_zero(dev, qdtype):
    """Image 0 attends nothing (every live slot carries its own label),
    whose slots hold NaN codes and scales: its rows are exactly 0 and its
    LSE +1e30; image 1 attends them."""
    from must3r_tpu_torch.memory import quantize_kv
    from must3r_tpu_torch.ops import _kernels

    gen = torch.Generator(device=dev).manual_seed(23)
    q = _randn(gen, dev, 1, 2, 130, 12, DH)
    codes, scale = quantize_kv(_randn(gen, dev, 1, 12, 1024, 2 * DH), qdtype)
    lab = torch.full((1, 1024), -1, dtype=torch.int32, device=dev)
    lab[0, :700] = 4
    qs = torch.tensor([[4, -2]], dtype=torch.int32, device=dev)
    qu = torch.full((1, 2), INT32_MAX, dtype=torch.int32, device=dev)
    out, lse = _kernels.ca_fwd_q8(q, codes, scale, lab, qs, qu, 700,
                                  return_stats=True)
    assert torch.isfinite(out).all()
    assert float(out[:, 0].abs().max()) == 0.0
    assert bool((lse[:, 0] == tatt.EMPTY_LSE).all())
    assert float(out[:, 1].abs().max()) > 0.0


def _fused_case(dev, seed, b, g, n, n_imgs, per_img, q_self, q_upper, ext_p,
                s_extra=0, heads=12):
    """A K5 call of the training path: a memory of n_imgs images of per_img
    tokens (kv [B, H, kv_len + s_extra, 128]), the step's masks, and lse /
    delta from the plain forward."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kv_len = n_imgs * per_img
    s_cap = kv_len + s_extra
    q = _randn(gen, dev, b, g, n, heads, DH)
    kv = _randn(gen, dev, b, heads, s_cap, 2 * DH)
    lab = _labels(dev, s_cap, kv_len, per_img).expand(b, s_cap).contiguous()
    qs = torch.tensor([q_self] * b, dtype=torch.int32, device=dev)
    qu = torch.tensor([q_upper] * b, dtype=torch.int32, device=dev)
    ext = (torch.rand(b, g, s_cap, generator=gen, device=dev) < ext_p
           if ext_p else None)
    dout = _randn(gen, dev, b, g, n, heads, DH)
    _, lse, delta = _plain_stats(q, kv, lab, qs, qu, kv_len, ext, dout)
    return (q, kv, lab, qs, qu, kv_len, lse, delta, dout, ext)


FUSED_CASES = {
    # the init pair of the 512 step: [2, 2, 768] against 1,536 keys
    "init_pair": (2, 2, 768, 2, 768, [-2, 1], [2, 1], 0.1),
    # the 224 recipe's last block: 5 images of 196 rows (a ragged 64-row
    # tail) against 20 images of 196 tokens, causal, dropout mask
    "224_last_block": (1, 5, 196, 20, 196, [15, 16, 17, 18, 19],
                       [15, 16, 17, 18, 19], 0.1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_ca_bwd_fused_sm90_matches_plain(dev, case):
    """K5 against its plain version at the training path's shapes; one
    launch of K5 and none of K3 / K4. dq is summed by reduce-adds in no
    fixed order: held to the same bounds."""
    from must3r_tpu_torch.ops import _kernels

    args = _fused_case(dev, 24, *FUSED_CASES[case], s_extra=100)
    want_dq, want_dkv = tatt._ca_bwd_fused_plain(*args)
    tatt.reset_launch_counts()
    dq, dkv = _kernels.ca_bwd_fused(*args)
    counts = tatt.launch_counts()
    assert (counts["ca_bwd_fused"], counts["ca_bwd_dq"],
            counts["ca_bwd_dkv"]) == (1, 0, 0)
    _assert_matches_plain(dq, want_dq)
    _assert_matches_plain(dkv[..., :DH], want_dkv[..., :DH])
    _assert_matches_plain(dkv[..., DH:], want_dkv[..., DH:])
    kv_len = args[5]
    assert float(dkv[:, :, kv_len:].abs().max()) == 0.0


@pytest.mark.cuda
def test_ca_bwd_fused_sm90_empty_rows_and_dead_keys(dev):
    """Image 1 attends nothing (LSE +1e30): its dq is exactly 0 and, with
    the gradient only on it, dK|dV is 0 everywhere; with the gradient on
    image 0, dK|dV is live up to kv_len and exactly 0 past it (a whole key
    block past kv_len, and the tail of a live one)."""
    from must3r_tpu_torch.ops import _kernels

    q, kv, lab, qs, qu, kv_len, lse, delta, dout, ext = _fused_case(
        dev, 25, 2, 2, 300, 3, 300, [-2, 0], [1, 1], 0.0, s_extra=300)
    assert bool((lse[:, 1] == tatt.EMPTY_LSE).all())
    dout1 = dout.clone()
    dout1[:, 0] = 0
    tatt.reset_launch_counts()
    dq, dkv = _kernels.ca_bwd_fused(q, kv, lab, qs, qu, kv_len, lse,
                                    torch.zeros_like(delta), dout1, ext)
    counts = tatt.launch_counts()
    assert (counts["ca_bwd_fused"], counts["ca_bwd_dq"],
            counts["ca_bwd_dkv"]) == (1, 0, 0)
    for t in (dq, dkv):
        assert torch.isfinite(t).all() and float(t.abs().max()) == 0.0
    dq, dkv = _kernels.ca_bwd_fused(q, kv, lab, qs, qu, kv_len, lse, delta,
                                    dout, ext)
    assert float(dq[:, 1].abs().max()) == 0.0
    assert float(dkv[:, :, kv_len:].abs().max()) == 0.0
    assert float(dkv[:, :, :300].abs().max()) > 0.0
    want_dq, want_dkv = tatt._ca_bwd_fused_plain(q, kv, lab, qs, qu, kv_len,
                                                 lse, delta, dout, ext)
    _assert_matches_plain(dq, want_dq)
    _assert_matches_plain(dkv, want_dkv)
