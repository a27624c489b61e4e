"""The share of the traced window's device busy time spent in the DPT
heads' kernels (%): convolutions (forward and transposed, cuDNN's and
PyTorch's own), their layout transforms and the bilinear resampling, told
apart by name. The trace keeps no link from a device kernel to the host
span that launched it, so the heads' kernels are taken by their families:
the rest of the model runs no convolution and no resampling. Their
elementwise kernels (LayerNorm, ReLU, the activations), and a 1 x 1
convolution that cuDNN hands to a plain GEMM kernel, are not counted."""

import re

FAMILIES = re.compile(
    r"conv(?!ert)|fprop|dgrad|implicit_gemm|implicit_convolve|winograd|"
    r"nchwToNhwc|nhwcToNchw|col2im|im2col|upsample_bilinear",
    re.IGNORECASE)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    busy = tr.busy_s()
    heads = [(max(a, tr.t0_ns), min(b, tr.t1_ns), n) for a, b, n in tr.device
             if FAMILIES.search(n)]
    if busy <= 0.0 or not heads:
        return None
    merged = type(tr)(device=heads, host=[], t0_ns=tr.t0_ns, t1_ns=tr.t1_ns)
    return 100.0 * merged.busy_s() / busy
