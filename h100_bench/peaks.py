"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit) and the
least time of a hand kernel's work, from its shapes.

The bound arithmetic is a copy of the program's ``chip_smoke.py`` as it stood
when the benchmark was made: each input byte read once and each output byte
written once, the operations the algorithm needs, against device memory's
bandwidth and the float32 rate outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 dense, the MFU's peak


def softmax_moments_bound(b, h, w, k):
    elems = b * h * w * k
    bytes_ = 4 * elems + 4 * elems + 4 * b * k * 5     # logits in, parts + raw out
    flops = 17 * elems                                  # max; exp+sum; exp, div, 5 fma
    return bytes_, flops


def render_assemble_bound(b, k, f, res):
    bytes_ = 4 * b * k * 2 + 4 * b * k * 4 + 2 * b * k * f + 4 * b * res * res * f
    flops = b * res * res * k * (2 * f + 12)            # φ (~12) + Σ_k φ·a (2 per channel)
    return bytes_, flops


def render_backward_bound(b, k, f, res):
    # Read μ, Λ, a (bf16) and the f32 cotangent g once; write d_μ, d_Λ, d_a.
    bytes_ = (4 * b * k * 6 + 2 * b * k * f + 4 * b * res * res * f
              + 4 * b * k * 6 + 2 * b * k * f)
    flops = b * res * res * k * (4 * f + 24)   # g_φ and d_a: 2 per channel each; φ, g_d, 5 sums
    return bytes_, flops


def tps_warp_bound(b, h, w, c, m, elt):
    bytes_ = 2 * elt * b * h * w * c + 4 * b * m * 2 + 4 * h * w * m   # image, out; w; basis
    flops = b * h * w * (4 * m + 10 * c)                                # flow dot; 4-tap lerp
    return bytes_, flops


def bound_ms(bytes_, flops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decoder_scales(model: dict):
    """(resolution, width) of each decoder scale."""
    n = model["decoder_scales"]
    out = model["decoder_out_size"] or model["img_size"]
    feats = model["decoder_features"]
    return [(out // 2 ** (n - 1 - i), feats[min(i, len(feats) - 1)]) for i in range(n)]
