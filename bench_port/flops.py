"""The yardstick's arithmetic: peaks, each kernel's least time, and the
analytic operation count of the chain and of the training step.

Operations are counted at two a multiply-add, for every convolution,
linear layer and attention product the mathematics needs, from the
configuration's shapes alone: whatever kernel, library call or fusion runs
the work, the count is the same.  Element-wise work (norms, activations,
softmax, resizes) is not counted.  Training counts the forward, the input
gradients the trainable adapter's gradients need, and the adapter's weight
gradients; recomputation (activation checkpointing) is the
implementation's and is not counted.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
989e12 bf16 tensor-core operations/s, 67e12 float32 operations/s outside
the tensor cores, 3.35e12 bytes/s of HBM3.  ``PEAK_EXPS`` is a reckoning,
not a published figure: 16 ``ex2`` a clock on each of 132 SMs at ~1.83 GHz.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PEAK_BF16_FLOPS", "PEAK_F32_FLOPS", "PEAK_BYTES", "PEAK_EXPS",
           "least_s", "attn_fwd_bound", "attn_bwd_bounds", "conv_bound",
           "gn_bound", "Ops", "unet_ops", "controlnet_ops", "hint_ops",
           "vae_decode_ops", "vae_encode_ops", "clip_ops",
           "chain_flops_per_image", "train_step_flops"]

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXPS = 3.9e12

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(flops: float, nbytes: float, peak_flops: float,
            exps: float = 0.0) -> float:
    """The least time for the operations at ``peak_flops``, the
    exponentials at ``PEAK_EXPS`` and the bytes at the HBM rate: the
    largest of the three."""
    return max(flops / peak_flops, exps / PEAK_EXPS, nbytes / PEAK_BYTES)


def _peak(dtype: str) -> float:
    return PEAK_F32_FLOPS if dtype == "float32" else PEAK_BF16_FLOPS


def attn_fwd_bound(b, h, nq, nk, d, lse, dtype) -> float:
    """A flash forward (K1, or K2/K3 with its combine pass): q, k, v read
    once, the output (and the f32 lse) written once."""
    es = ESIZE[dtype]
    return least_s(4.0 * b * h * nq * nk * d,
                   es * b * h * d * (2 * nq + 2 * nk)
                   + (4.0 * b * h * nq if lse else 0.0),
                   _peak(dtype), exps=1.0 * b * h * nq * nk)


def attn_bwd_bounds(b, h, nq, nk, d, dtype) -> Tuple[float, float]:
    """(dQ kernel K5, dK/dV kernel K6): each recomputes P (one exp a
    score); K5 reads q, k, v, dO and the row statistics and writes dQ, K6
    reads the same and writes dK, dV."""
    es, bh = ESIZE[dtype], b * h
    ops, exps = 1.0 * bh * nq * nk * d, 1.0 * bh * nq * nk
    k5 = least_s(6.0 * ops, es * d * bh * (3.0 * nq + 2 * nk) + 8.0 * bh * nq,
                 _peak(dtype), exps)
    k6 = least_s(8.0 * ops, es * d * bh * (2.0 * nq + 4 * nk) + 8.0 * bh * nq,
                 _peak(dtype), exps)
    return k5, k6


def conv_bound(n, c, co, h, w, dtype) -> float:
    """A 3x3 stride-1 conv (K7 with its pre-pass): x, the weight and bias
    read once, the output written once."""
    es = ESIZE[dtype]
    return least_s(2.0 * n * h * w * 9 * c * co,
                   es * n * h * w * (c + co) + es * co * 9.0 * c + 4.0 * co,
                   _peak(dtype))


def gn_bound(shape: Sequence[int], dtype: str) -> float:
    """GroupNorm + affine + SiLU (K4): one read, one write, ~8 float32
    operations an element."""
    numel = 1
    for s in shape:
        numel *= s
    return least_s(8.0 * numel, 2.0 * numel * ESIZE[dtype] + 8.0 * shape[1],
                   PEAK_F32_FLOPS)


# --- analytic operation counts ----------------------------------------------

@dataclasses.dataclass
class Ops:
    """Forward operations of a model run, split by what a backward through
    it needs: ``fwd`` all; ``dx`` the input gradients of the layers after
    ``grad_from`` (the first place a trainable feature enters); ``dw`` the
    trainable weights' gradients."""

    fwd: float = 0.0
    dx: float = 0.0
    dw: float = 0.0

    def __iadd__(self, o: "Ops") -> "Ops":
        self.fwd += o.fwd
        self.dx += o.dx
        self.dw += o.dw
        return self


def _conv(n, cin, cout, k, h, w):
    return 2.0 * n * cin * cout * k * k * h * w


def _lin(tokens, cin, cout):
    return 2.0 * tokens * cin * cout


def _attn(n, heads, nq, nk, d):
    return 4.0 * n * heads * nq * nk * d


class _Walk:
    """Accumulates one model run: ``grad`` says whether the layers now
    being added sit on the gradient's path."""

    def __init__(self):
        self.ops = Ops()
        self.grad = False

    def layer(self, f, dx=True):
        """A conv or linear: its input gradient is needed on the path
        unless ``dx`` is False (its input needs no gradient)."""
        self.ops.fwd += f
        if self.grad and dx:
            self.ops.dx += f

    def attention(self, f, cross: bool):
        """q.k^T and p.v; backward: dP and dQ, plus dK and dV when the keys
        and values need a gradient (self-attention)."""
        self.ops.fwd += f
        if self.grad:
            self.ops.dx += f if cross else 2 * f


def _res(wk: _Walk, n, cin, cout, h, w, emb):
    wk.layer(_conv(n, cin, cout, 3, h, w))
    wk.layer(_lin(n, emb, cout), dx=False)   # the timestep embedding
    wk.layer(_conv(n, cout, cout, 3, h, w))
    if cin != cout:
        wk.layer(_conv(n, cin, cout, 1, h, w))


def _transformer(wk: _Walk, n, c, heads, h, w, ctx_len, ctx_dim):
    t = n * h * w
    d = c // heads
    wk.layer(_conv(n, c, c, 1, h, w))                    # proj_in
    for _ in range(3):                                   # self q, k, v
        wk.layer(_lin(t, c, c))
    wk.attention(_attn(n, heads, h * w, h * w, d), cross=False)
    wk.layer(_lin(t, c, c))                              # to_out
    wk.layer(_lin(t, c, c))                              # cross q
    for _ in range(2):                                   # cross k, v
        wk.layer(_lin(n * ctx_len, ctx_dim, c), dx=False)
    wk.attention(_attn(n, heads, h * w, ctx_len, d), cross=True)
    wk.layer(_lin(t, c, c))                              # to_out
    wk.layer(_lin(t, c, 8 * c))                          # GEGLU proj
    wk.layer(_lin(t, 4 * c, c))
    wk.layer(_conv(n, c, c, 1, h, w))                    # proj_out


def _encoder_walk(wk: _Walk, p, n, hh, ww, ctx_len, level_end=None,
                  taps=None):
    """The SD encoder (input blocks and middle block); ``level_end(i,
    level, h, w)`` is called after each level's last block, ``taps(c, h,
    w)`` after every input block and the middle (ControlNet's zero
    convs)."""
    mc, heads, ctx = p["model_channels"], p["num_heads"], p["context_dim"]
    emb = 4 * mc
    wk.layer(_conv(n, p["in_channels"], mc, 3, hh, ww), dx=False)
    ch, ds, h, w = mc, 1, hh, ww
    if taps:
        taps(ch, h, w)
    mult = p["channel_mult"]
    for level, m in enumerate(mult):
        for _ in range(p["num_res_blocks"]):
            _res(wk, n, ch, m * mc, h, w, emb)
            ch = m * mc
            if ds in p["attention_resolutions"]:
                _transformer(wk, n, ch, heads, h, w, ctx_len, ctx)
            if taps:
                taps(ch, h, w)
        if level_end:
            level_end(level, ch, h, w)
        if level != len(mult) - 1:
            h, w = h // 2, w // 2
            wk.layer(_conv(n, ch, ch, 3, h, w))
            ds *= 2
            if taps:
                taps(ch, h, w)
    _res(wk, n, ch, ch, h, w, emb)
    _transformer(wk, n, ch, heads, h, w, ctx_len, ctx)
    _res(wk, n, ch, ch, h, w, emb)
    return ch, ds, h, w


def _adapter(p, a, n, hh, ww, trainable: bool) -> Ops:
    """The FG-DM adapter pyramid: conv_in, then per level ``nums_rb``
    blocks (2x2 pool into the level, a 1x1 in-conv where the channels
    change, conv3x3 -> conv1x1).  Trainable: each conv's weight gradient,
    and every input gradient but conv_in's."""
    mc, ks = p["model_channels"], a.get("ksize", 1)
    chans = [m * mc for m in p["channel_mult"]]
    convs = [(_conv(n, a.get("cin", 4), chans[0], 3, hh, ww), False)]
    h, w = hh, ww
    for i, ch in enumerate(chans):
        for j in range(a.get("nums_rb", 2)):
            cin = chans[i - 1] if i and not j else ch
            if i and not j:
                h, w = h // 2, w // 2
            if cin != ch:
                convs.append((_conv(n, cin, ch, ks, h, w), True))
            convs.append((_conv(n, ch, ch, 3, h, w), True))
            convs.append((_conv(n, ch, ch, ks, h, w), True))
    ops = Ops(fwd=sum(f for f, _ in convs))
    if trainable:
        ops.dw = ops.fwd
        ops.dx = sum(f for f, dx in convs if dx)
    return ops


def unet_ops(cfg, n, hh, ww, ctx_len=77, adapter=False,
             trainable_adapter=False) -> Ops:
    """One UNet forward on ``n`` latents of ``hh x ww``: the encoder, the
    middle block, the decoder with its skips, the head, and the adapter
    when on.  With ``trainable_adapter`` the gradient's path starts where
    the first adapter feature is added."""
    p, mc = cfg["unet"], cfg["unet"]["model_channels"]
    wk = _Walk()
    wk.layer(_lin(n, mc, 4 * mc), dx=False)           # time embedding
    wk.layer(_lin(n, 4 * mc, 4 * mc), dx=False)
    if adapter:
        wk.ops += _adapter(p, cfg.get("adapter", {}), n, hh, ww,
                           trainable_adapter)

    def level_end(level, ch, h, w):
        if adapter and trainable_adapter:
            wk.grad = True

    skips = []
    ch, ds, h, w = _encoder_walk(
        wk, p, n, hh, ww, ctx_len, level_end,
        taps=lambda c, h_, w_: skips.append(c))
    mult, heads = p["channel_mult"], p["num_heads"]
    for level, m in reversed(list(enumerate(mult))):
        for i in range(p["num_res_blocks"] + 1):
            _res(wk, n, ch + skips.pop(), m * mc, h, w, 4 * mc)
            ch = m * mc
            if ds in p["attention_resolutions"]:
                _transformer(wk, n, ch, heads, h, w, ctx_len,
                             p["context_dim"])
            if level and i == p["num_res_blocks"]:
                h, w = 2 * h, 2 * w
                wk.layer(_conv(n, ch, ch, 3, h, w))
                ds //= 2
    wk.layer(_conv(n, mc, p["out_channels"], 3, h, w))
    return wk.ops


def controlnet_ops(cfg, n, hh, ww, ctx_len=77) -> Ops:
    """ControlNet's encoder copy and its 1x1 zero convs (the hint pyramid
    runs once a sample: ``hint_ops``)."""
    p = cfg["control"]
    mc = p["model_channels"]
    wk = _Walk()
    wk.layer(_lin(n, mc, 4 * mc), dx=False)
    wk.layer(_lin(n, 4 * mc, 4 * mc), dx=False)
    taps: List[Tuple[int, int, int]] = []
    ch, _, h, w = _encoder_walk(wk, p, n, hh, ww, ctx_len,
                                taps=lambda c, h_, w_: taps.append((c, h_,
                                                                    w_)))
    taps.append((ch, h, w))                           # middle_block_out
    for c, h_, w_ in taps:
        wk.layer(_conv(n, c, c, 1, h_, w_))
    return wk.ops


def hint_ops(cfg, n, hh, ww) -> float:
    """The hint pyramid at image size ``hh x ww``: seven convs (three of
    stride 2), then the conv to the model's width."""
    p = cfg["control"]
    chans = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))
    f, cin, h, w = 0.0, p["hint_channels"], hh, ww
    for cout, stride in chans:
        h, w = h // stride, w // stride
        f += _conv(n, cin, cout, 3, h, w)
        cin = cout
    return f + _conv(n, cin, p["model_channels"], 3, h, w)


def _vae_res(n, cin, cout, h, w):
    f = _conv(n, cin, cout, 3, h, w) + _conv(n, cout, cout, 3, h, w)
    return f + (_conv(n, cin, cout, 1, h, w) if cin != cout else 0.0)


def _vae_attn(n, c, h, w):
    return 4 * _conv(n, c, c, 1, h, w) + _attn(n, 1, h * w, h * w, c)


def vae_decode_ops(cfg, n, lh, lw) -> float:
    """post_quant_conv and the decoder, from an ``lh x lw`` latent."""
    p = cfg["vae"]
    dd = p["ddconfig"]
    ch, mult, z = dd["ch"], dd["ch_mult"], dd["z_channels"]
    h, w = lh, lw
    cin = ch * mult[-1]
    f = _conv(n, p["embed_dim"], z, 1, h, w) + _conv(n, z, cin, 3, h, w)
    f += 2 * _vae_res(n, cin, cin, h, w) + _vae_attn(n, cin, h, w)
    for i in reversed(range(len(mult))):
        for _ in range(dd["num_res_blocks"] + 1):
            f += _vae_res(n, cin, ch * mult[i], h, w)
            cin = ch * mult[i]
        if i:
            h, w = 2 * h, 2 * w
            f += _conv(n, cin, cin, 3, h, w)
    return f + _conv(n, cin, dd["out_ch"], 3, h, w)


def vae_encode_ops(cfg, n, hh, ww) -> float:
    """The encoder and quant_conv, from an ``hh x ww`` image."""
    p = cfg["vae"]
    dd = p["ddconfig"]
    ch, mult, z = dd["ch"], dd["ch_mult"], dd["z_channels"]
    h, w = hh, ww
    f = _conv(n, dd["in_channels"], ch, 3, h, w)
    cin = ch
    for i, m in enumerate(mult):
        for _ in range(dd["num_res_blocks"]):
            f += _vae_res(n, cin, ch * m, h, w)
            cin = ch * m
        if i != len(mult) - 1:
            h, w = h // 2, w // 2
            f += _conv(n, cin, cin, 3, h, w)
    f += 2 * _vae_res(n, cin, cin, h, w) + _vae_attn(n, cin, h, w)
    f += _conv(n, cin, 2 * z, 3, h, w)
    return f + _conv(n, 2 * z, 2 * p["embed_dim"], 1, h, w)


def clip_ops(cfg, n) -> float:
    """The text tower over ``n`` sequences of ``max_length`` tokens."""
    p = cfg["clip"]
    t, d = n * p["max_length"], p["width"]
    per = 4 * _lin(t, d, d) + _attn(n, p["heads"], p["max_length"],
                                    p["max_length"], d // p["heads"])
    return p["layers"] * (per + _lin(t, d, 4 * d) + _lin(t, 4 * d, d))


def chain_flops_per_image(cfg) -> Dict[str, float]:
    """The chain's operations for one image, by stage, and ``total``: four
    CLIP contexts, factor 1 (the UNet with adapter on the guided pair, each
    step), the map's decode, the hint pyramid, factor 2 (ControlNet + UNet
    on the guided pair, each step) and the image's decode."""
    s = cfg["sampler"]
    ch, cw = (v // 8 for v in s["cond_hw"])
    ih, iw = (v // 8 for v in s["image_hw"])
    parts = {
        "clip": clip_ops(cfg, 4),
        "factor1": s["f1_steps"] * unet_ops(cfg, 2, ch, cw, adapter=True).fwd,
        "decode_map": vae_decode_ops(cfg, 1, ch, cw),
        "hint": hint_ops(cfg, 1, *s["image_hw"]),
        "factor2": s["f2_steps"] * (unet_ops(cfg, 2, ih, iw).fwd
                                    + controlnet_ops(cfg, 2, ih, iw).fwd),
        "decode_image": vae_decode_ops(cfg, 1, ih, iw),
    }
    parts["total"] = sum(parts.values())
    return parts


def _capture_scores(cfg, n, hh, ww, self_n: Optional[int], pool: int,
                    ctx_len=77) -> Tuple[float, float]:
    """The head-averaged score maps of a capture forward, one product per
    captured layer over the pooled self tokens and the context tokens:
    ``(all layers, the layers after the first adapter feature)`` (the
    encoder's first level runs before it, so its maps take no gradient)."""
    p = cfg["unet"]
    mc, nrb = p["model_channels"], p["num_res_blocks"]
    layers = []   # (channels, h, w, after the first adapter feature)
    h, w = hh, ww
    for level, m in enumerate(p["channel_mult"]):
        if 2 ** level in p["attention_resolutions"]:
            layers += [(m * mc, h, w, level > 0)] * nrb          # encoder
            layers += [(m * mc, h, w, True)] * (nrb + 1)         # decoder
        if level != len(p["channel_mult"]) - 1:
            h, w = h // 2, w // 2
    layers.append((p["channel_mult"][-1] * mc, h, w, True))      # middle
    total = after = 0.0
    for c, h_, w_, late in layers:
        nt = h_ * w_
        f = 2.0 * n * nt * ctx_len * c
        if self_n is not None and nt == self_n:
            f += 2.0 * n * (nt // pool) ** 2 * c
        total += f
        after += f if late else 0.0
    return total, after


def train_step_flops(cfg, batch: int, hw) -> Dict[str, float]:
    """One adapter training step's operations at ``batch`` images of
    ``hw``: ``plain`` (VAE encode, CLIP, the UNet with adapter forward and
    the backward the adapter needs) and ``distill`` (plain plus the
    student's captured score maps and their backward on the first ``tb``
    rows, and the frozen teacher's forward on the 2x latent with its
    pooled maps)."""
    lh, lw = hw[0] // 8, hw[1] // 8
    u = unet_ops(cfg, batch, lh, lw, adapter=True, trainable_adapter=True)
    plain = (vae_encode_ops(cfg, batch, *hw) + clip_ops(cfg, batch)
             + u.fwd + u.dx + u.dw)
    tb = min(max(2, batch // 10), 8, batch)
    s_all, s_late = _capture_scores(cfg, tb, lh, lw, lh * lw, 1)
    teacher = (unet_ops(cfg, tb, 2 * lh, 2 * lw).fwd
               + _capture_scores(cfg, tb, 2 * lh, 2 * lw, 4 * lh * lw, 4)[0])
    return {"plain": plain, "distill": plain + s_all + 2 * s_late + teacher}
