"""Attention of the PyTorch port against the JAX package's Pallas kernels.

The JAX side runs ``_sa_pallas`` / ``_ca_pallas`` in interpret mode on the
CPU (``interpret=True`` passed explicitly); the port side runs the plain
versions of kernels K1 / K2, which CPU tensors take. Same numpy inputs, fp32,
Dh = 64, rtol = atol = 2e-5 (the JAX package's own kernel-vs-reference
tolerance). The CUDA kernels themselves are tested in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from must3r_tpu.ops.attention import INT32_MAX, _ca_pallas, _sa_pallas
from must3r_tpu_torch.memory import quantize_kv
from must3r_tpu_torch.models.layers import EncoderBlock, encoder_block
from must3r_tpu_torch.ops import attention as tatt
from must3r_tpu_torch.ops import bench_kernels
from must3r_tpu_torch.ops import fp8

TOL = dict(rtol=2e-5, atol=2e-5)
DH = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,n,h", [(2, 50, 2), (1, 96, 3)])
def test_sa_plain_matches_pallas(rng, b, n, h):
    q, k, v = (rng.standard_normal((b, n, h, DH)).astype(np.float32)
               for _ in range(3))
    want = _sa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      block_q=32, block_k=32, interpret=True)
    got = tatt.self_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sa_plain_chunked_matches_single_chunk(rng):
    """The online softmax over several key chunks equals one chunk."""
    q, k, v = (_t(rng.standard_normal((1, 70, 2, DH)).astype(np.float32))
               for _ in range(3))
    np.testing.assert_allclose(tatt._sa_plain(q, k, v, chunk=16).numpy(),
                               tatt._sa_plain(q, k, v).numpy(), **TOL)


def _labels(rng, b, s, live, n_imgs):
    lab = np.full((b, s), -1, np.int32)
    lab[:, :live] = rng.integers(0, n_imgs, size=(b, live))
    return lab


def _ca_case(rng, b, g, n, h, s, live, q_self, q_upper, layers=None):
    q = rng.standard_normal((b, g, n, h, DH)).astype(np.float32)
    shape = (b, h, s, 2 * DH) if layers is None else (layers, b, h, s, 2 * DH)
    kv = rng.standard_normal(shape).astype(np.float32)
    lab = _labels(rng, b, s, live, 4)
    # every query image must see at least one key (no fully-masked rows,
    # where the JAX kernels are known to differ; see the dedicated test)
    lab[:, 0] = 3
    lab[:, 1] = 0
    lab[:, 2] = 1
    return (q, kv, lab, np.asarray(q_self, np.int32),
            np.asarray(q_upper, np.int32))


CA_CASES = {
    # update-like: self-exclusion + causality, kv_len stops mid-block
    "update_masks": dict(b=1, g=2, n=24, h=2, s=64, live=40,
                         q_self=[[1, -2]], q_upper=[[3, INT32_MAX]]),
    "batch2": dict(b=2, g=1, n=17, h=2, s=48, live=37,
                   q_self=[[2], [0]], q_upper=[[INT32_MAX], [3]]),
    # render: G*N query rows flattened into one image axis, no masks
    "render_flat": dict(b=1, g=1, n=3 * 20, h=2, s=64, live=60,
                        q_self=[[-2]], q_upper=[[INT32_MAX]]),
}


@pytest.mark.parametrize("case", sorted(CA_CASES))
def test_ca_plain_matches_pallas(rng, case):
    c = CA_CASES[case]
    q, kv, lab, qs, qu = _ca_case(rng, c["b"], c["g"], c["n"], c["h"],
                                  c["s"], c["live"], c["q_self"],
                                  c["q_upper"])
    want = _ca_pallas(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(lab),
                      jnp.asarray(qs), jnp.asarray(qu), jnp.int32(c["live"]),
                      block_k=16, interpret=True)
    got = tatt.memory_cross_attention(_t(q), _t(kv), _t(lab), _t(qs), _t(qu),
                                      kv_len=c["live"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer", [0, 2])
def test_ca_plain_5d_cache_layer_matches_pallas(rng, layer):
    q, kv, lab, qs, qu = _ca_case(rng, 1, 2, 16, 2, 48, 35, [[0, 1]],
                                  [[INT32_MAX, INT32_MAX]], layers=3)
    want = _ca_pallas(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(lab),
                      jnp.asarray(qs), jnp.asarray(qu), jnp.int32(35),
                      jnp.int32(layer), block_k=16, interpret=True)
    got = tatt.memory_cross_attention(_t(q), _t(kv), _t(lab), _t(qs), _t(qu),
                                      kv_len=35, layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ca_kv_len_skips_tail(rng):
    """Slots at or past kv_len are never read, whatever they hold."""
    q, kv, lab, qs, qu = _ca_case(rng, 1, 1, 8, 2, 64, 64, [[-2]],
                                  [[INT32_MAX]])
    kv2 = kv.copy()
    kv2[:, :, 30:] = np.nan
    a = tatt.memory_cross_attention(_t(q), _t(kv), _t(lab), _t(qs), _t(qu),
                                    kv_len=30)
    b = tatt.memory_cross_attention(_t(q), _t(kv2), _t(lab), _t(qs), _t(qu),
                                    kv_len=30)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kv_len", [0, 40])
def test_ca_fully_masked_row_is_zero(rng, kv_len):
    """A query image that attends no key gets 0 (the JAX chunked path and
    the Pallas kernel return a mean of V there instead)."""
    q = _t(rng.standard_normal((1, 2, 8, 2, DH)).astype(np.float32))
    kv = _t(rng.standard_normal((1, 2, 64, 2 * DH)).astype(np.float32))
    lab = np.full((1, 64), -1, np.int32)
    lab[:, :40] = 5
    qs = _t(np.asarray([[5, -2]], np.int32))        # image 0 masks label 5
    qu = _t(np.asarray([[INT32_MAX, INT32_MAX]], np.int32))
    out = tatt.memory_cross_attention(q, kv, _t(lab), qs, qu, kv_len=kv_len)
    assert torch.isfinite(out).all()
    assert float(out[:, 0].abs().max()) == 0.0
    if kv_len:
        assert float(out[:, 1].abs().max()) > 0.0


def test_ca_chunked_matches_single_chunk(rng):
    q, kv, lab, qs, qu = _ca_case(rng, 1, 2, 10, 2, 64, 50, [[0, 2]],
                                  [[INT32_MAX, 3]])
    k, v = _t(kv[..., :DH]), _t(kv[..., DH:])
    args = (_t(q), k, v, _t(lab), _t(qs), _t(qu), 50)
    np.testing.assert_allclose(tatt._ca_plain(*args, chunk=16).numpy(),
                               tatt._ca_plain(*args).numpy(), **TOL)


def test_cpu_tensors_leave_launch_counts_alone(rng):
    tatt.reset_launch_counts()
    q = _t(rng.standard_normal((1, 20, 2, DH)).astype(np.float32))
    tatt.self_attention(q, q, q)
    kv = _t(rng.standard_normal((1, 2, 16, 2 * DH)).astype(np.float32))
    tatt.memory_cross_attention(q[:, None], kv, torch.zeros(1, 16,
                                                            dtype=torch.int32))
    codes, scale = quantize_kv(kv, torch.int8)
    tatt.memory_cross_attention(q[:, None], codes,
                                torch.zeros(1, 16, dtype=torch.int32),
                                kv_scale=scale)
    x = torch.linspace(-8, 8, 256).reshape(2, 128).to(torch.float8_e4m3fn)
    fp8.fp8_dequant_dot(fp8.fp8_to_bf16_x2(x).to(torch.float8_e4m3fn),
                        torch.ones(128, 4, dtype=torch.bfloat16))
    bench_kernels.memory_cross_attention_2h(
        q[:, None], kv[None], torch.zeros(1, 16, dtype=torch.int32), 16, 0)
    bench_kernels.ln_matmul(q[0, :, 0], torch.ones(DH), torch.zeros(DH),
                            torch.ones(DH, 4))
    blk = EncoderBlock(2 * DH, 4.0, 1e-6, num_heads=2)
    with torch.no_grad():
        encoder_block(blk, q.reshape(1, 20, 2 * DH).to(torch.bfloat16), None,
                      2)
    counts = tatt.launch_counts()
    assert set(counts) == {"sa_fwd", "ca_fwd", "ca_bwd_dq", "ca_bwd_dkv",
                           "ca_bwd_fused", "ca_fwd_q8", "fp8_to_bf16_x2",
                           "fp8_dequant_dot", "ca_fwd_2h", "ln_matmul",
                           "ln_cast", "qkv_glue", "residual_glue",
                           "bias_gelu"}
    assert not any(counts.values()), counts


@pytest.mark.parametrize("fn", ["sa", "ca"])
def test_kernel_impl_refuses_cpu_tensors(fn):
    """The kernel wrappers never fall back to the plain version."""
    from must3r_tpu_torch.ops import _kernels

    q = torch.zeros(1, 8, 2, DH, dtype=torch.bfloat16)
    i32 = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if fn == "sa":
            _kernels.sa_fwd(q, q, q)
        else:
            _kernels.ca_fwd(q[:, None],
                            torch.zeros(1, 2, 16, 2 * DH,
                                        dtype=torch.bfloat16),
                            torch.zeros(1, 16, dtype=torch.int32), i32, i32,
                            16)


def test_bad_impl_and_kv_len_raise():
    q = torch.zeros(1, 1, 4, 1, DH)
    kv = torch.zeros(1, 1, 16, 2 * DH)
    lab = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        tatt.memory_cross_attention(q, kv, lab, kv_len=17)
    with pytest.raises(ValueError):
        tatt.self_attention(q[0], q[0], q[0], impl="pallas")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without the CUDA toolkit the kernels do not build, and nothing falls
    back to the plain version."""
    from must3r_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
