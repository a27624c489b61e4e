"""The CA training path of the PyTorch port against the JAX package: the
forward with LSE and a token-dropout mask, the three backward kernels' plain
versions and autograd through the port's CA Function.

The JAX side runs the Pallas kernels in interpret mode on the CPU
(``interpret=True`` passed explicitly) or, for autograd, ``jax.vjp`` of
``_ca_chunked``; the port side runs the plain versions of K2..K5, which CPU
tensors take. Same numpy inputs, fp32, Dh = 64, rtol = atol = 2e-5 (the
tolerance of the forward tests, test_torch_attention.py). The JAX kernels
pad the LSE rows to their block; the port does not, so the first N rows are
compared. Every query image attends at least one key (rows that attend
nothing are defined differently; see test_empty_rows_have_zero_gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from must3r_tpu.ops import attention as jatt
from must3r_tpu.ops.attention import INT32_MAX
from must3r_tpu_torch.ops import attention as tatt

TOL = dict(rtol=2e-5, atol=2e-5)
DH = 64

# (b, g, n, h, s, live, q_self, q_upper): g = 2 with n <= 1024 is a folded
# shape in the JAX routing (fused backward), g = 1 is not (dq + dkv);
# "blocks_g1" spans two of the JAX kernels' 512-key blocks, several 128-key
# blocks of K4 and a partial 64-row tile of K3
CASES = {
    "blocks_g1": (1, 1, 130, 1, 1024, 700, [[1]], [[INT32_MAX]]),
    "update_g1": (1, 1, 24, 2, 64, 40, [[1]], [[INT32_MAX]]),
    "causal_g2": (1, 2, 20, 2, 64, 48, [[-2, 1]], [[2, 1]]),
    "batch2_g2": (2, 2, 17, 2, 32, 29, [[0, 2], [3, -2]],
                  [[INT32_MAX, 3], [INT32_MAX, INT32_MAX]]),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, name, with_ext=True):
    b, g, n, h, s, live, qs, qu = CASES[name]
    q = rng.standard_normal((b, g, n, h, DH)).astype(np.float32)
    kv = rng.standard_normal((b, h, s, 2 * DH)).astype(np.float32)
    lab = np.full((b, s), -1, np.int32)
    lab[:, :live] = rng.integers(0, 4, size=(b, live))
    lab[:, :3] = (3, 0, 1)         # every image attends at least one key
    ext = None
    if with_ext:
        ext = rng.random((b, g, s)) < 0.3
        ext[:, :, :3] = False
    dout = rng.standard_normal(q.shape).astype(np.float32)
    return dict(q=q, kv=kv, lab=lab, qs=np.asarray(qs, np.int32),
                qu=np.asarray(qu, np.int32), live=live, ext=ext, dout=dout)


def _jax_fwd(c):
    ext = None if c["ext"] is None else jnp.asarray(c["ext"].astype(np.int32))
    return jatt._ca_pallas(jnp.asarray(c["q"]), jnp.asarray(c["kv"])[None],
                           jnp.asarray(c["lab"]), jnp.asarray(c["qs"]),
                           jnp.asarray(c["qu"]), jnp.int32(c["live"]),
                           jnp.int32(0), interpret=True, return_stats=True,
                           ext=ext)


def _jax_delta(c, out, lse):
    """delta in the JAX kernels' padded row layout (_ca_hybrid_ext_bwd)."""
    delta = jnp.sum(jnp.asarray(c["dout"]) * out, axis=-1).transpose(
        0, 1, 3, 2)[..., None]
    pad = lse.shape[3] - delta.shape[3]
    return jnp.pad(delta, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0)))


def _port_stats(c):
    """(out, lse, delta) of the port's plain forward."""
    k, v = _t(c["kv"][..., :DH]), _t(c["kv"][..., DH:])
    ext = None if c["ext"] is None else _t(c["ext"])
    out, lse = tatt._ca_plain(_t(c["q"]), k, v, _t(c["lab"]), _t(c["qs"]),
                              _t(c["qu"]), c["live"], ext, return_stats=True)
    delta = (_t(c["dout"]) * out).sum(-1).permute(0, 1, 3, 2).contiguous()
    return out, lse, delta


def _port_args(c):
    out, lse, delta = _port_stats(c)
    ext = None if c["ext"] is None else _t(c["ext"])
    return (_t(c["q"]), _t(c["kv"]), _t(c["lab"]), _t(c["qs"]), _t(c["qu"]),
            c["live"], lse, delta, _t(c["dout"]), ext)


def _jax_bwd_args(c):
    out, lse = _jax_fwd(c)
    ext = None if c["ext"] is None else jnp.asarray(c["ext"].astype(np.int32))
    return ((jnp.asarray(c["q"]), jnp.asarray(c["kv"])[None],
             jnp.asarray(c["lab"]), jnp.asarray(c["qs"]), jnp.asarray(c["qu"]),
             jnp.int32(c["live"]), jnp.int32(0), lse, _jax_delta(c, out, lse),
             jnp.asarray(c["dout"])), ext)


@pytest.mark.parametrize("with_ext", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ca_forward_with_stats_matches_pallas(rng, name, with_ext):
    c = _case(rng, name, with_ext)
    want_out, want_lse = _jax_fwd(c)
    out, lse, _ = _port_stats(c)
    n = c["q"].shape[2]
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse)[:, :, :, :n, 0], **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ca_bwd_dq_and_dkv_plain_match_pallas(rng, name):
    c = _case(rng, name)
    jargs, jext = _jax_bwd_args(c)
    want_dq = jatt._ca_bwd_dq_pallas(*jargs, interpret=True, ext=jext)
    want_dkv = jatt._ca_bwd_dkv_pallas(*jargs, interpret=True, ext=jext)
    args = _port_args(c)
    np.testing.assert_allclose(tatt._ca_bwd_dq_plain(*args).numpy(),
                               np.asarray(want_dq), **TOL)
    np.testing.assert_allclose(tatt._ca_bwd_dkv_plain(*args).numpy(),
                               np.asarray(want_dkv), **TOL)


@pytest.mark.parametrize("name", ["causal_g2", "batch2_g2"])
def test_ca_bwd_fused_plain_matches_pallas(rng, name):
    c = _case(rng, name)
    g, n = c["q"].shape[1:3]
    assert tatt._fold_stripe(g, n) is not None       # a folded shape
    jargs, jext = _jax_bwd_args(c)
    want_dq, want_dkv = jatt._ca_bwd_fused_pallas(*jargs, interpret=True,
                                                  ext=jext)
    dq, dkv = tatt._ca_bwd_fused_plain(*_port_args(c))
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), **TOL)
    np.testing.assert_allclose(dkv.numpy(), np.asarray(want_dkv), **TOL)


@pytest.mark.parametrize("with_ext", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ca_function_grads_match_jax_vjp(rng, name, with_ext):
    c = _case(rng, name, with_ext)
    k, v = c["kv"][..., :DH], c["kv"][..., DH:]
    ext = None if c["ext"] is None else jnp.asarray(c["ext"])

    def f(q, k, v):
        return jatt._ca_chunked(q, k, v, jnp.asarray(c["lab"]),
                                jnp.asarray(c["qs"]), jnp.asarray(c["qu"]),
                                ext)

    out_j, vjp = jax.vjp(f, jnp.asarray(c["q"]), jnp.asarray(k),
                         jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(c["dout"]))
    q = _t(c["q"]).requires_grad_()
    kv = _t(c["kv"]).requires_grad_()
    out = tatt.memory_cross_attention(
        q, kv, _t(c["lab"]), _t(c["qs"]), _t(c["qu"]), kv_len=c["live"],
        extra_mask=None if c["ext"] is None else _t(c["ext"]))
    out.backward(_t(c["dout"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(dq_j), **TOL)
    np.testing.assert_allclose(kv.grad[..., :DH].numpy(), np.asarray(dk_j),
                               **TOL)
    np.testing.assert_allclose(kv.grad[..., DH:].numpy(), np.asarray(dv_j),
                               **TOL)


@pytest.mark.parametrize("name,fused", [("update_g1", False),
                                        ("causal_g2", True)])
def test_ca_backward_routes_like_the_jax_package(rng, monkeypatch, name,
                                                 fused):
    """The Function's backward takes the fused version exactly where the
    JAX predicate _fold_stripe(G, N) holds, dq + dkv elsewhere."""
    calls = []
    for fn in ("_ca_bwd_fused_plain", "_ca_bwd_dq_plain",
               "_ca_bwd_dkv_plain"):
        orig = getattr(tatt, fn)
        monkeypatch.setattr(tatt, fn, lambda *a, _f=orig, _n=fn:
                            calls.append(_n) or _f(*a))
    c = _case(rng, name)
    q = _t(c["q"]).requires_grad_()
    tatt.memory_cross_attention(q, _t(c["kv"]), _t(c["lab"]), _t(c["qs"]),
                                _t(c["qu"]), kv_len=c["live"]).sum().backward()
    want = (["_ca_bwd_fused_plain"] if fused
            else ["_ca_bwd_dq_plain", "_ca_bwd_dkv_plain"])
    assert calls == want


def test_empty_rows_have_zero_gradients(rng):
    """A query image that attends nothing: out = 0, LSE = +1e30, so the
    backward's p = exp(s - lse) is 0: dq = 0 and no dK/dV from it."""
    c = _case(rng, "causal_g2", with_ext=False)
    c["lab"][:, :] = -1
    c["lab"][:, :10] = 1                    # image 0 (q_upper 2) sees these;
    c["qs"] = np.asarray([[-2, 1]], np.int32)   # image 1 masks label 1
    q = _t(c["q"]).requires_grad_()
    kv = _t(c["kv"]).requires_grad_()
    out, lse, _ = _port_stats(c)
    assert bool((lse[:, 1] == torch.tensor(tatt.EMPTY_LSE)).all())
    got = tatt.memory_cross_attention(q, kv, _t(c["lab"]), _t(c["qs"]),
                                      _t(c["qu"]), kv_len=c["live"])
    dout = torch.zeros_like(got)
    dout[:, 1] = 1.0                        # gradient only into image 1
    got.backward(dout)
    assert torch.isfinite(q.grad).all() and torch.isfinite(kv.grad).all()
    assert float(got[:, 1].abs().max()) == 0.0
    assert float(q.grad.abs().max()) == 0.0
    assert float(kv.grad.abs().max()) == 0.0
    # keys past kv_len get exactly 0 as well
    args = _port_args(c)
    assert float(tatt._ca_bwd_dkv_plain(*args)[:, :, c["live"]:].abs().max()
                 ) == 0.0


def test_ca_bwd_chunked_matches_single_chunk(rng):
    """The plain backwards over several key chunks equal one chunk."""
    c = _case(rng, "causal_g2")
    args = _port_args(c)
    one = tatt._ca_bwd_fused_plain(*args)
    orig = tatt._ca_bwd_chunks

    def small(*a, chunk=1024):
        return orig(*a, chunk=16)
    tatt._ca_bwd_chunks = small
    try:
        many = tatt._ca_bwd_fused_plain(*args)
    finally:
        tatt._ca_bwd_chunks = orig
    for a, b in zip(one, many):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
