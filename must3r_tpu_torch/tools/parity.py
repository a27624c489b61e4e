"""The rules that hold a kernel against its plain PyTorch version.

Both round P (and ds) to bf16 and differ only in summation order, so they
agree to about one bf16 ulp of the largest output, and the bounds scale with
the reference (attention over thousands of random keys gives outputs of
~0.1, where a fixed 0.05 would pass a wrong kernel): max abs error <=
min(0.05, 2e-2 x max|plain|) (0.05 is the bf16 P.V tolerance of the JAX
kernel tests; 2e-2 is >= 2.5 bf16 ulps) and relative RMSE <= 1e-2.
"""

from __future__ import annotations

import math

import torch

TOL = 0.05            # absolute cap on max abs error
MAX_ERR_REL = 2e-2    # max abs error <= this * max|plain|
RMSE_REL = 1e-2       # relative RMSE of the kernel vs its plain version
# bf16_agreement: the share of elements bitwise equal, and the slack (of
# max|plain|) beside one bf16 ulp for an output that cancels to near 0
EQUAL_SHARE = 0.999
CANCEL_SLACK = 2.0 ** -16


def rel_rmse(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).square().mean() / b.square().mean()).sqrt())


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def kernel_error(got, want, ulp_allowance: bool = False) -> dict:
    """Errors of a kernel's output against its plain version, each beside
    its bound; ``ok`` when every one holds and the output is finite. With
    ``ulp_allowance`` the max abs bound adds one bf16 ulp of max|plain| (for
    a kernel whose bf16 rounding of an intermediate feeds a long sum)."""
    err = float((got.double() - want.double()).abs().max())
    ref_max = float(want.double().abs().max())
    rmse = rel_rmse(got, want)
    bound = min(TOL, MAX_ERR_REL * ref_max)
    if ulp_allowance:
        bound += bf16_ulp(ref_max)
    ok = bool(torch.isfinite(got).all()) and err <= bound and \
        rmse <= RMSE_REL
    return dict(max_abs_err=err, max_abs_bound=bound, max_abs_plain=ref_max,
                rel_rmse=rmse, ok=ok)


def bf16_ulps(got, want) -> torch.Tensor:
    """bf16 ulps between two bf16 tensors (their bit patterns in order)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i + 32768), i)
    return (ordered(got) - ordered(want)).abs()


def bf16_agreement(got, want) -> dict:
    """Two bf16 tensors that round the same fp32 arithmetic at the same
    points, with fp32 sums (LayerNorm statistics) taken in another order
    (the block glue G1-G4 against their plain statements). The fp32 values
    before the rounding differ by a few fp32 ulps of the terms, so each
    output is within one bf16 ulp of the larger of the two, or, where it
    cancels to near 0 (an affine's bias against its product, RoPE's
    difference), within a few fp32 ulps of the terms: ``CANCEL_SLACK`` x
    max|plain| covers both with ~15x room. ``ok`` also asks that
    ``EQUAL_SHARE`` of the elements are equal bit for bit; 'ulps' and
    'equal' report the largest ulp distance and that share."""
    g, w = got.double(), want.double()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    err = (g - w).abs()
    limit = ulp + CANCEL_SLACK * float(w.abs().max())
    u = bf16_ulps(got, want)
    equal = float((u == 0).double().mean())
    ok = bool(torch.isfinite(g).all()) and bool((err <= limit).all()) and \
        equal >= EQUAL_SHARE
    return dict(ulps=int(u.max()), equal=equal, max_abs_err=float(err.max()),
                past_limit=int((err > limit).sum()), ok=ok)
