"""FLOP and byte counts from shapes, and the card's published peaks.

The per-launch counts of the fused kernels (K1-K4, K7) follow the arithmetic
the kernels must do: two FLOP per multiply-add, each input byte read once,
each output byte written once, each weight read once and each weight
gradient written once. The step counts (``srf_step_flops``,
``flow_query_flops``) are the model FLOPs that ``mfu`` divides by the peak:
every convolution and matrix product of the forward and of the inverse that
the loss uses, twice that again for the backward where there is one, and
the RBF encoding's arithmetic. Elementwise work outside the encoding is not
counted, so a share of the peak computed from them cannot pass 100% on any
implementation of the same model.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# published NVIDIA H100 SXM peaks (data sheet, dense, 700 W)
PEAK_TF32 = 495e12       # FLOP/s, TF32 on the tensor cores
PEAK_FP32 = 67e12        # FLOP/s, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12     # bytes/s, HBM3

# FLOP of the RBF encoding per (point, centre): x.c over d = 3 coordinates
# (3 multiply-adds), |x|^2 + |c|^2 - 2 x.c (3), the clamp, the product with
# sigma^2 and its negation, the exponential
RBF_FLOP_PER_PAIR = 6 + 3 + 1 + 2 + 1


def coupling_cost(m: int, c: int, hidden: int, elem_bytes: int = 4
                  ) -> Tuple[int, int]:
    """FLOP and bytes of one 1x1 GLOW coupling launch (K1 forward or K2
    inverse) over m pixels of c channels: four products per pixel; x read
    once, y written once, each weight and bias read once (fp32)."""
    len1 = c // 2
    len2 = c - len1
    flops = 2 * m * hidden * (len2 + 2 * len1 + len1 + 2 * len2)
    weights = (len2 * hidden + hidden + hidden * 2 * len1 + 2 * len1
               + len1 * hidden + hidden + hidden * 2 * len2 + 2 * len2)
    return flops, 2 * m * c * elem_bytes + 4 * weights


def backward_cost(m: int, c: int, hidden: int, elem_bytes: int = 4,
                  inverse: bool = False) -> Tuple[int, int]:
    """FLOP and bytes of one K3 (or, with ``inverse``, K4) launch with its
    reduction: K4 18 H C FLOP a pixel (the recompute, the dx chain and the
    weight gradients, 6 H C each), K3 2 H len2 fewer (its chain never reads
    t1); x and g read once, dx written once, each weight read once and each
    weight gradient written once."""
    fwd, _ = coupling_cost(m, c, hidden, elem_bytes)
    flops = 3 * fwd - (0 if inverse else 2 * m * hidden * (c - c // 2))
    weights = (coupling_cost(1, c, hidden, 4)[1] - 2 * c * 4) // 4
    return flops, 3 * m * c * elem_bytes + 2 * 4 * weights


def inr_forward_cost(n: int, widths: Sequence[int]) -> Tuple[int, int]:
    """FLOP and bytes of the MLP of ``widths`` = [E, H, ..., H, O] over n
    encoded points (a non-progressive net, a constant mask): 2 FLOP per
    multiply-add of every layer; the points (d = 3) read once, the output
    written once, each weight and bias read once."""
    mats = [a * b for a, b in zip(widths[:-1], widths[1:])]
    params = sum(mats) + sum(widths[1:])
    return 2 * n * sum(mats), 4 * (n * (3 + widths[-1]) + params)


def inr_backward_cost(n: int, widths: Sequence[int]) -> Tuple[int, int]:
    """FLOP and bytes of one K7 backward launch with its reduction over n
    points: the recompute of the hidden layers, every weight gradient, and
    the g chain through all layers but the first; x and g read once, each
    weight and bias read once and its gradient written once."""
    mats = [a * b for a, b in zip(widths[:-1], widths[1:])]
    flops = 2 * n * (sum(mats[:-1]) + sum(mats) + sum(mats[1:]))
    params = sum(mats) + sum(widths[1:])
    return flops, 4 * (n * (3 + widths[-1]) + 2 * params)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOP at the
    TF32 peak and the bytes at the memory rate."""
    return max(flops / PEAK_TF32, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# SRF (the invertible network of ``sr``)
# ---------------------------------------------------------------------------

def srf_couplings(cfg: Dict) -> List[Dict]:
    """The GLOW couplings of the SRF for a config dict: per coupling its
    octave's spatial size (rows, cols of one HR frame after the squeezes),
    channels c, split len1 and subnet kernel (3 for even, 1 for odd
    positions in an octave)."""
    h, w = cfg["hr_height"], cfg["hr_width"]
    c = 3 * 4
    h, w = h // 2, w // 2
    out = []
    octaves = (cfg["scale"] - 1).bit_length()
    for _ in range(octaves):
        h, w, c = h // 2, w // 2, c * 4
        for kk in range(cfg["num_coupling"]):
            out.append({"h": h, "w": w, "c": c, "len1": c // 2,
                        "kernel": 3 if kk % 2 == 0 else 1})
    return out


def coupling_conv_flops(m: int, c: int, len1: int, kernel: int,
                        hidden: int) -> int:
    """FLOP of one coupling's four convolutions over m pixels (either
    direction): s2 maps len2 -> H -> 2 len1, s1 maps len1 -> H -> 2 len2."""
    len2 = c - len1
    macs = kernel * kernel * hidden * (len2 + 2 * len1 + len1 + 2 * len2)
    return 2 * m * macs


def srf_pass_flops(cfg: Dict, batch: int) -> int:
    """FLOP of one pass of the SRF (forward or inverse) over ``batch`` HR
    frames: the couplings' convolutions."""
    return sum(coupling_conv_flops(batch * c["h"] * c["w"], c["c"], c["len1"],
                                   c["kernel"], cfg["hidden_channels"])
               for c in srf_couplings(cfg))


def srf_step_flops(cfg: Dict, batch: int) -> int:
    """Model FLOP of one SR train step: the forward and the inverse pass of
    the loss, and twice that for the backward."""
    return 3 * 2 * srf_pass_flops(cfg, batch)


def srf_1x1_launches(cfg: Dict, batch: int) -> List[Tuple[int, int]]:
    """(m, c) of each 1x1 coupling a pass launches, in order."""
    return [(batch * c["h"] * c["w"], c["c"]) for c in srf_couplings(cfg)
            if c["kernel"] == 1]


# ---------------------------------------------------------------------------
# Flow INR
# ---------------------------------------------------------------------------

def inr_widths(cfg: Dict) -> List[int]:
    """[E, H, ..., H, O] of the RBF net: E = 2 x num_frequencies centres."""
    return ([2 * cfg["num_frequencies"]] + [cfg["hidden_dim"]]
            * cfg["num_layers"] + [cfg["output_channels"]])


def rbf_encoding_flops(n: int, cfg: Dict) -> int:
    return RBF_FLOP_PER_PAIR * n * 2 * cfg["num_frequencies"]


def flow_query_flops(cfg: Dict, pairs: int, height: int, width: int) -> int:
    """Model FLOP of one INR query of ``pairs`` frame pairs (both flows of a
    pair come from one query of its pose grid): the encoding and the MLP."""
    n = pairs * height * width
    return rbf_encoding_flops(n, cfg) + inr_forward_cost(n, inr_widths(cfg))[0]


def flow_train_step_flops(cfg: Dict, pairs: int, height: int,
                          width: int) -> int:
    """Model FLOP of one flow train step: the query, and twice the MLP's
    products for the backward (the encoding has no parameter)."""
    n = pairs * height * width
    return (flow_query_flops(cfg, pairs, height, width)
            + 2 * inr_forward_cost(n, inr_widths(cfg))[0])
