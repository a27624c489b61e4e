"""The microbenchmark kernels of the PyTorch port against the JAX package, on
the CPU: the plain versions of K6 (``ca_fwd_2h``, two heads per block) and
K7 (``ln_matmul``) against the Pallas kernels they replace,
``_ca_pallas_2h`` of ``scripts/bench_ca_kernel.py`` and ``pallas_ln_matmul``
of ``scripts/bench_fused_chain.py`` (loaded by file path), run in the TPU
interpret mode; the ops' limits; both bench tools on the CPU.

Tolerances, each with its reason:
  * the 2h CA, fp32: 1e-5 (the same online softmax over 128-key blocks
    against 1024-key chunks: another summation order, scores ~1);
  * LN + matmul, fp32: 1e-5 (the same fp32 arithmetic in another order);
    bf16 inputs: one bf16 ulp of the output's largest value (the normalised
    rows are rounded to bf16 in both, and an fp32 difference of an ulp in
    the statistics can move one rounding by one bf16 ulp).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from must3r_tpu_torch.ops import _kernels
from must3r_tpu_torch.ops import attention as tatt
from must3r_tpu_torch.ops import bench_kernels as tbk
from must3r_tpu_torch.tools import bench_ca_kernel, bench_fused_chain

ROOT = pathlib.Path(__file__).resolve().parents[1]
DH = 64


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ca_script():
    return _script("bench_ca_kernel")


@pytest.fixture(scope="module")
def chain_script():
    return _script("bench_fused_chain")


# As in test_torch_train.py: few torch threads per test, so that the test
# workers' threads do not oversubscribe the host while XLA compiles.
@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _ca_inputs(rng, b, n, h, s, kv_len, layers=2):
    q = rng.standard_normal((b, 1, n, h, DH)).astype(np.float32)
    kv = rng.standard_normal((layers, b, h, s, 2 * DH)).astype(np.float32)
    # live labels 0..2 with free slots (-1) among them; -1 at and past
    # kv_len (the TPU kernel's precondition)
    labels = rng.integers(-1, 3, size=(b, s)).astype(np.int32)
    labels[:, :8] = 0                 # the first block attends something
    labels[:, kv_len:] = -1
    return q, kv, labels


# 200: the last 128-key block partly live; 256: every slot; 129: one live
# key in the second block; 1: one live key in all
@pytest.mark.parametrize("kv_len", [200, 256, 129, 1])
def test_ca_2h_plain_matches_the_interpret_mode_kernel(ca_script, kv_len):
    rng = np.random.default_rng(kv_len)
    q, kv, labels = _ca_inputs(rng, b=2, n=100, h=4, s=256, kv_len=kv_len)
    with pltpu.force_tpu_interpret_mode():
        want = ca_script._ca_pallas_2h(jnp.asarray(q), jnp.asarray(kv),
                                       jnp.asarray(labels), kv_len=kv_len,
                                       layer=1, block_k=128, block_q=128)
    want = np.asarray(jax.block_until_ready(want))
    assert np.isfinite(want).all()
    # One torch thread (the autouse fixture restores the count): with two,
    # the plain version's output changed in 3 of 24 runs beside six busy
    # processes, by up to 3.5e-5; with one, in none of 24, and the JAX
    # side's in none of 48.
    torch.set_num_threads(1)
    got = tbk.memory_cross_attention_2h(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(labels),
        kv_len, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_ca_2h_plain_is_the_ca_with_the_label_mask_alone():
    """Against the port's memory_cross_attention with q_self / q_upper
    disabled: the same function on the layer's view."""
    rng = np.random.default_rng(1)
    q, kv, labels = _ca_inputs(rng, b=1, n=70, h=2, s=192, kv_len=150)
    args = [torch.from_numpy(a) for a in (q, kv, labels)]
    got = tbk.memory_cross_attention_2h(*args, 150, 0)
    want = tatt.memory_cross_attention(args[0], args[1], args[2],
                                       kv_len=150, layer=0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_ca_2h_row_that_attends_nothing_is_zero():
    """Where the TPU kernel's precondition fails (no live key) the port
    keeps K2's definition: out = 0, no NaN."""
    rng = np.random.default_rng(2)
    q, kv, labels = _ca_inputs(rng, b=1, n=30, h=2, s=128, kv_len=128)
    labels[:] = -1
    out = tbk.memory_cross_attention_2h(*(torch.from_numpy(a) for a in
                                          (q, kv, labels)), 128, 1)
    assert float(out.abs().max()) == 0.0
    empty = tbk.memory_cross_attention_2h(*(torch.from_numpy(a) for a in
                                            (q, kv, labels)), 0, 1)
    assert float(empty.abs().max()) == 0.0


@pytest.mark.parametrize("g,h", [(2, 4), (1, 3)])
def test_ca_2h_refuses_what_the_tpu_kernel_asserts(g, h):
    q = torch.zeros(1, g, 8, h, DH)
    kv = torch.zeros(2, 1, h, 64, 2 * DH)
    labels = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="G = 1" if g != 1 else "even"):
        tbk.memory_cross_attention_2h(q, kv, labels, 64, 0)


def _ln_inputs(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32) * 3 + 1
    g = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    return x, g, b, w


@pytest.mark.parametrize("dtype,m,n", [("float32", 256, 256),
                                       ("bfloat16", 256, 256),
                                       ("float32", 384, 384)])
def test_ln_matmul_plain_matches_the_interpret_mode_kernel(chain_script,
                                                           dtype, m, n):
    """Blocks of 128 rows and columns: 256 gives a 2 x 2 grid, 384 a 3 x 3
    grid."""
    rng = np.random.default_rng(3)
    arrs = _ln_inputs(rng, m, 128, n)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    with pltpu.force_tpu_interpret_mode():
        want = chain_script.pallas_ln_matmul(
            *(jnp.asarray(a, jdt) for a in arrs), block_m=128, block_n=128)
    want = np.asarray(jax.block_until_ready(want).astype(jnp.float32))
    got = tbk.ln_matmul(*(torch.from_numpy(a).to(tdt) for a in arrs))
    assert got.dtype == tdt and got.shape == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        tol = 1e-5
    else:                             # one bf16 ulp of the largest output
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_ln_matmul_plain_ragged_rows_match_layer_norm_then_matmul():
    """Any row count: each row is normalised on its own (population
    variance, eps 1e-6), as F.layer_norm does."""
    rng = np.random.default_rng(4)
    x, g, b, w = (torch.from_numpy(a) for a in _ln_inputs(rng, 77, 128, 256))
    got = tbk.ln_matmul(x, g, b, w)
    want = torch.nn.functional.layer_norm(x, (128,), g, b, tbk.LN_EPS) @ w
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,n,limit", [(100, 256, "multiple of 64"),
                                       (8256, 256, "at most 8192"),
                                       (128, 200, "multiple of 128")])
def test_ln_matmul_kernel_names_the_tiling_limit(k, n, limit):
    x = torch.zeros(4, k, dtype=torch.bfloat16)
    g = b = torch.zeros(k, dtype=torch.bfloat16)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=limit):
        _kernels.ln_matmul(x, g, b, w)


def test_the_new_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 8, 2, DH, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 2, 64, 2 * DH, dtype=torch.bfloat16)
    labels = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.ca_fwd_2h(q, kv, labels, 64, 0)
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.ln_matmul(x, x[0], x[0], torch.zeros(128, 128,
                                                      dtype=torch.bfloat16))


def test_bench_ca_kernel_runs_on_the_cpu(capsys):
    tatt.reset_launch_counts()
    res = bench_ca_kernel.main(["--check", "--tiny", "--device", "cpu",
                                "render_10v_512"])
    out = capsys.readouterr().out
    assert "2h parity OK" in out
    for variant in ("kernel", "kernel2h", "plain"):
        assert f"render_10v_512     {variant}" in out
    assert [r["variant"] for r in res["rows"]] == ["kernel", "kernel2h",
                                                   "plain"]
    assert not any(tatt.launch_counts().values())


def test_bench_fused_chain_runs_on_the_cpu(capsys):
    tatt.reset_launch_counts()
    res = bench_fused_chain.main(["--tiny", "--device", "cpu", "update_qkv"])
    out = capsys.readouterr().out
    assert "update_qkv [256,128]->384" in out and "max_err 0.00e+00" in out
    assert res["rows"][0]["max_abs_err"] == 0.0
    assert not any(tatt.launch_counts().values())
