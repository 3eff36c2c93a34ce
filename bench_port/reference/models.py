"""Plain PyTorch models of the SD-1.4 FG-DM chain, for the benchmark's check.

The SD-1.4 UNet (with the FG-DM adapter), the SD ControlNet, the SD VAE
(AutoencoderKL, f8, 4 latent channels) and the CLIP ViT-L/14 text tower,
written from the published architectures in plain ``torch`` float32 with
no kernels, no fusion and no layout tricks.  Module names follow the
CompVis / HuggingFace checkpoint schema, so a state dict in that schema
loads into these modules and into the program's alike.

``set_fp8(model, True)`` switches every convolution, linear layer and
attention product to take its operands rounded to float8 e4m3 (one scale
per tensor, from its absolute maximum) and to accumulate in float32: the
control that a check must reject (a precision below the bf16 the
configuration states).

This file imports nothing of the program.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet", "ControlNet", "AutoencoderKL", "CLIPText", "set_fp8",
           "timestep_embedding"]

_FP8_MAX = 448.0   # float8 e4m3's largest finite value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor, back in
    float32; the gradient passes through unrounded (a float8 gradient
    would underflow unscaled), and the backward's products read the
    rounded operands the forward saved."""
    x = x.float()
    with torch.no_grad():
        scale = _FP8_MAX / x.abs().amax().clamp(min=1e-12)
        q = (x * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach() if x.requires_grad else q


class _Op(nn.Module):
    """A layer whose operands may be rounded to fp8 (``set_fp8``)."""

    fp8 = False

    def q(self, x):
        return fp8_round(x) if self.fp8 else x.float()


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Op):
            m.fp8 = on
    return model


class Conv2d(_Op):
    def __init__(self, cin, cout, k=3, stride=1, padding=None, bias=True):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias,
                        self.stride, self.padding)


class Linear(_Op):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class GroupNorm(nn.Module):
    def __init__(self, c, eps=1e-5, groups=32):
        super().__init__()
        self.eps, self.groups = eps, groups
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            self.eps)


class LayerNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight,
                            self.bias, self.eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period=10000):
    """Sinusoidal embedding, cos then sin (CompVis ``util.py``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Attention(_Op):
    """Softmax attention over ``[B, H, N, D]``, float32 scores; with
    ``scores`` also the head-averaged pre-softmax scores, the key and query
    tokens average-pooled in flat windows of ``pool`` first."""

    def forward(self, q, k, v, scale, scores=False, pool=1):
        q, k, v = self.q(q), self.q(k), self.q(v)
        sim = torch.matmul(q, k.transpose(-1, -2)) * scale
        out = torch.matmul(self.q(torch.softmax(sim, dim=-1)), v)
        if not scores:
            return out, None
        h = q.shape[1]
        qs, ks = q * (scale / h), k
        if pool > 1:
            b, _, nq, d = qs.shape
            qs = qs.reshape(b, h, nq // pool, pool, d).mean(dim=3)
            ks = ks.reshape(b, h, ks.shape[2] // pool, pool, d).mean(dim=3)
        return out, torch.einsum("bhid,bhjd->bij", qs, ks)


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim=None, heads=8, d_head=64):
        super().__init__()
        inner = heads * d_head
        self.heads, self.d_head = heads, d_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx_dim or dim, inner, bias=False)
        self.to_v = Linear(ctx_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.attend = Attention()

    def forward(self, x, context=None, capture=None):
        """``capture``: None, or ``(self_n, pool)``: return the scores of a
        cross layer, and of a self layer over ``self_n`` tokens, pooled."""
        ctx = x if context is None else context

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.d_head).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(
            self.to_v(ctx))
        want = capture is not None and (context is not None
                                        or x.shape[1] == capture[0])
        pool = capture[1] if want and context is None else 1
        out, maps = self.attend(q, k, v, self.d_head ** -0.5, want, pool)
        b, h, n, d = out.shape
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, h * d)), maps


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, d_head, ctx_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=heads, d_head=d_head)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, d_head)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim)
                                              for _ in range(3))

    def forward(self, x, context, capture=None):
        y, m_self = self.attn1(self.norm1(x), capture=capture)
        x = x + y
        y, m_cross = self.attn2(self.norm2(x), context, capture)
        x = x + y
        return x + self.ff(self.norm3(x)), (m_self, m_cross)


class SpatialTransformer(nn.Module):
    def __init__(self, c, heads, d_head, ctx_dim):
        super().__init__()
        inner = heads * d_head
        self.norm = GroupNorm(c, eps=1e-6)
        self.proj_in = Conv2d(c, inner, 1, padding=0)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, d_head, ctx_dim)])
        self.proj_out = Conv2d(inner, c, 1, padding=0)

    def forward(self, x, context, capture=None):
        b, _, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        c = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h, maps = self.transformer_blocks[0](h, context, capture)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x, maps


class ResBlock(nn.Module):
    def __init__(self, cin, emb_ch, cout):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm(cin), nn.Identity(),
                                        Conv2d(cin, cout, 3)])
        self.emb_layers = nn.ModuleList([nn.Identity(),
                                         Linear(emb_ch, cout)])
        self.out_layers = nn.ModuleList([GroupNorm(cout), nn.Identity(),
                                         nn.Identity(), Conv2d(cout, cout, 3)])
        self.skip_connection = (nn.Identity() if cin == cout
                                else Conv2d(cin, cout, 1, padding=0))

    def forward(self, x, emb):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.op = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv2d(c, c, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _run(block, h, emb, context, capture=None, maps=None):
    for layer in block:
        if isinstance(layer, ResBlock):
            h = layer(h, emb)
        elif isinstance(layer, SpatialTransformer):
            h, m = layer(h, context, capture)
            if maps is not None:
                maps.append(m)
        else:
            h = layer(h)
    return h


def _encoder(cin, mc, n_res, attn_res, mult, heads, ctx_dim):
    """The SD encoder: ``(input_blocks, middle_block, skip channels, the
    input-block index ending each level)``."""
    emb = 4 * mc
    blocks = [nn.ModuleList([Conv2d(cin, mc, 3)])]
    chans, ends, ch, ds = [mc], [], mc, 1
    for level, m in enumerate(mult):
        for _ in range(n_res):
            layers = [ResBlock(ch, emb, m * mc)]
            ch = m * mc
            if ds in attn_res:
                layers.append(SpatialTransformer(ch, heads, ch // heads,
                                                 ctx_dim))
            blocks.append(nn.ModuleList(layers))
            chans.append(ch)
        ends.append(len(blocks) - 1)
        if level != len(mult) - 1:
            blocks.append(nn.ModuleList([Downsample(ch)]))
            chans.append(ch)
            ds *= 2
    middle = nn.ModuleList([ResBlock(ch, emb, ch),
                            SpatialTransformer(ch, heads, ch // heads,
                                               ctx_dim),
                            ResBlock(ch, emb, ch)])
    return nn.ModuleList(blocks), middle, chans, ends


def _time_embed(mc):
    return nn.ModuleList([Linear(mc, 4 * mc), nn.Identity(),
                          Linear(4 * mc, 4 * mc)])


def _embed(te, t, mc):
    return te[2](F.silu(te[0](timestep_embedding(t, mc))))


class AdapterBlock(nn.Module):
    """T2I-Adapter ``ResnetBlock`` with ``sk=True``, ``use_conv=False``:
    2x2 average pool when ``down``, a ``ksize`` in-conv where the channels
    change, conv3x3 -> ReLU -> conv(ksize), identity skip."""

    def __init__(self, cin, cout, down, ksize):
        super().__init__()
        self.down = down
        self.in_conv = (Conv2d(cin, cout, ksize, padding=ksize // 2)
                        if cin != cout else None)
        self.block1 = Conv2d(cout, cout, 3)
        self.block2 = Conv2d(cout, cout, ksize, padding=ksize // 2)

    def forward(self, x):
        if self.down:
            x = F.avg_pool2d(x, 2)
        if self.in_conv is not None:
            x = self.in_conv(x)
        return self.block2(F.relu(self.block1(x))) + x


class Adapter(nn.Module):
    def __init__(self, channels, nums_rb=2, cin=4, ksize=1):
        super().__init__()
        self.nums_rb = nums_rb
        self.conv_in = Conv2d(cin, channels[0], 3)
        self.body = nn.ModuleList([
            AdapterBlock(channels[i - 1] if i and not j else ch, ch,
                         bool(i and not j), ksize)
            for i, ch in enumerate(channels) for j in range(nums_rb)])

    def forward(self, x):
        x = self.conv_in(x)
        feats = []
        for i, blk in enumerate(self.body):
            x = blk(x)
            if (i + 1) % self.nums_rb == 0:
                feats.append(x)
        return feats


class UNet(nn.Module):
    """The SD-1.x UNet; ``adapter`` adds the FG-DM adapter's feature of
    each level after the level's last input block."""

    def __init__(self, in_channels=4, model_channels=320, out_channels=4,
                 num_res_blocks=2, attention_resolutions=(4, 2, 1),
                 channel_mult=(1, 2, 4, 4), num_heads=8, context_dim=768,
                 adapter=True, adapter_nums_rb=2, adapter_ksize=1):
        super().__init__()
        mc = self.mc = model_channels
        self.time_embed = _time_embed(mc)
        self.adapter = (Adapter([m * mc for m in channel_mult],
                                adapter_nums_rb, in_channels, adapter_ksize)
                        if adapter else None)
        (self.input_blocks, self.middle_block, chans,
         self._ends) = _encoder(in_channels, mc, num_res_blocks,
                                attention_resolutions, channel_mult,
                                num_heads, context_dim)
        ch, ds = chans[-1], 2 ** (len(channel_mult) - 1)
        out = []
        for level, m in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), 4 * mc, m * mc)]
                ch = m * mc
                if ds in attention_resolutions:
                    layers.append(SpatialTransformer(ch, num_heads,
                                                     ch // num_heads,
                                                     context_dim))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                out.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(out)
        self.out = nn.ModuleList([GroupNorm(ch), nn.Identity(),
                                  Conv2d(mc, out_channels, 3)])

    def forward(self, x, t, context, adapter_on=True, control=None,
                capture=None):
        """eps; with ``capture`` (see ``CrossAttention``) also the list of
        ``(self, cross)`` maps of every transformer, in order."""
        emb = _embed(self.time_embed, t, self.mc)
        maps = [] if capture is not None else None
        feats = (self.adapter(x) if self.adapter is not None and adapter_on
                 else None)
        h, hs = x.float(), []
        for i, blk in enumerate(self.input_blocks):
            h = _run(blk, h, emb, context, capture, maps)
            if feats is not None and i in self._ends:
                h = h + feats.pop(0)
            hs.append(h)
        h = _run(self.middle_block, h, emb, context, capture, maps)
        ctrl = list(control) if control is not None else None
        if ctrl is not None:
            h = h + ctrl.pop()
        for blk in self.output_blocks:
            skip = hs.pop()
            if ctrl is not None:
                skip = skip + ctrl.pop()
            h = _run(blk, torch.cat([h, skip], dim=1), emb, context, capture,
                     maps)
        eps = self.out[2](F.silu(self.out[0](h)))
        return (eps, maps) if capture is not None else eps


# the hint pyramid's (out channels, stride), each conv followed by SiLU
_HINT = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class ControlNet(nn.Module):
    def __init__(self, in_channels=4, model_channels=320, hint_channels=3,
                 num_res_blocks=2, attention_resolutions=(4, 2, 1),
                 channel_mult=(1, 2, 4, 4), num_heads=8, context_dim=768):
        super().__init__()
        mc = self.mc = model_channels
        self.time_embed = _time_embed(mc)
        hint, cin = [], hint_channels
        for cout, stride in _HINT:
            hint += [Conv2d(cin, cout, 3, stride=stride, padding=1),
                     nn.Identity()]
            cin = cout
        hint.append(Conv2d(cin, mc, 3))
        self.input_hint_block = nn.ModuleList(hint)
        self.input_blocks, self.middle_block, chans, _ = _encoder(
            in_channels, mc, num_res_blocks, attention_resolutions,
            channel_mult, num_heads, context_dim)
        self.zero_convs = nn.ModuleList(
            [nn.ModuleList([Conv2d(c, c, 1, padding=0)]) for c in chans])
        self.middle_block_out = nn.ModuleList(
            [Conv2d(chans[-1], chans[-1], 1, padding=0)])

    def encode_hint(self, hint):
        g = hint.float()
        for conv in self.input_hint_block[:-1:2]:
            g = F.silu(conv(g))
        return self.input_hint_block[-1](g)

    def forward(self, x, hint_emb, t, context):
        emb = _embed(self.time_embed, t, self.mc)
        h, outs = x.float(), []
        for i, (blk, zc) in enumerate(zip(self.input_blocks,
                                          self.zero_convs)):
            h = _run(blk, h, emb, context)
            if i == 0:
                h = h + hint_emb
            outs.append(zc[0](h))
        h = _run(self.middle_block, h, emb, context)
        return outs + [self.middle_block_out[0](h)]


class VaeResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(cin, 1e-6)
        self.conv1 = Conv2d(cin, cout, 3)
        self.norm2 = GroupNorm(cout, 1e-6)
        self.conv2 = Conv2d(cout, cout, 3)
        self.nin_shortcut = (Conv2d(cin, cout, 1, padding=0) if cin != cout
                             else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class VaeAttn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = GroupNorm(c, 1e-6)
        self.q, self.k, self.v, self.proj_out = (
            Conv2d(c, c, 1, padding=0) for _ in range(4))
        self.attend = Attention()

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)

        def tokens(t):
            return t.reshape(b, c, hh * ww).transpose(1, 2)[:, None]

        a, _ = self.attend(tokens(self.q(h)), tokens(self.k(h)),
                           tokens(self.v(h)), c ** -0.5)
        return x + self.proj_out(a[:, 0].transpose(1, 2).reshape(
            b, c, hh, ww))


class _Level(nn.Module):
    pass


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                 in_channels=3, z_channels=4):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3)
        downs, cin = [], ch
        for i, m in enumerate(ch_mult):
            lv = _Level()
            lv.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                lv.block.append(VaeResBlock(cin, ch * m))
                cin = ch * m
            if i != len(ch_mult) - 1:
                lv.downsample = _Level()
                lv.downsample.conv = Conv2d(cin, cin, 3, stride=2, padding=0)
            downs.append(lv)
        self.down = nn.ModuleList(downs)
        self.mid = _Level()
        self.mid.block_1 = VaeResBlock(cin, cin)
        self.mid.attn_1 = VaeAttn(cin)
        self.mid.block_2 = VaeResBlock(cin, cin)
        self.norm_out = GroupNorm(cin, 1e-6)
        self.conv_out = Conv2d(cin, 2 * z_channels, 3)

    def forward(self, x):
        h = self.conv_in(x.float())
        for lv in self.down:
            for blk in lv.block:
                h = blk(h)
            if hasattr(lv, "downsample"):
                # the asymmetric (0, 1, 0, 1) pad of the CompVis encoder
                h = lv.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                 out_ch=3, z_channels=4):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, cin, 3)
        self.mid = _Level()
        self.mid.block_1 = VaeResBlock(cin, cin)
        self.mid.attn_1 = VaeAttn(cin)
        self.mid.block_2 = VaeResBlock(cin, cin)
        ups = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            lv = _Level()
            lv.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                lv.block.append(VaeResBlock(cin, ch * ch_mult[i]))
                cin = ch * ch_mult[i]
            if i:
                lv.upsample = Upsample(cin)
            ups[i] = lv
        self.up = nn.ModuleList(ups)
        self.norm_out = GroupNorm(cin, 1e-6)
        self.conv_out = Conv2d(cin, out_ch, 3)

    def forward(self, z):
        h = self.conv_in(z.float())
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for lv in reversed(self.up):
            for blk in lv.block:
                h = blk(h)
            if hasattr(lv, "upsample"):
                h = lv.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, embed_dim=4, ch=128, ch_mult=(1, 2, 4, 4),
                 num_res_blocks=2, z_channels=4):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, 3, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, 3, z_channels)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1, padding=0)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, padding=0)

    def encode_moments(self, x):
        """``(mean, logvar)`` of the posterior, logvar clamped to
        [-30, 20]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


class CLIPText(nn.Module):
    """The CLIP ViT-L/14 text tower (HF ``CLIPTextModel`` names): causal
    pre-LN transformer, quick-GELU MLP, final LayerNorm."""

    def __init__(self, vocab_size=49408, dim=768, layers=12, heads=12,
                 max_length=77):
        super().__init__()
        self.heads = heads
        tm = self.text_model = _Level()
        tm.embeddings = _Level()
        tm.embeddings.token_embedding = nn.Embedding(vocab_size, dim)
        tm.embeddings.position_embedding = nn.Embedding(max_length, dim)
        tm.encoder = _Level()
        tm.encoder.layers = nn.ModuleList()
        for _ in range(layers):
            layer = _Level()
            layer.layer_norm1 = LayerNorm(dim)
            layer.self_attn = _Level()
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(layer.self_attn, name, Linear(dim, dim))
            layer.layer_norm2 = LayerNorm(dim)
            layer.mlp = _Level()
            layer.mlp.fc1 = Linear(dim, 4 * dim)
            layer.mlp.fc2 = Linear(4 * dim, dim)
            tm.encoder.layers.append(layer)
        tm.final_layer_norm = LayerNorm(dim)
        self.attend = Attention()

    def forward(self, ids):
        tm = self.text_model
        b, n = ids.shape
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[None, :n])
        mask = torch.triu(torch.full((n, n), -torch.inf, device=x.device), 1)
        d = x.shape[-1] // self.heads
        for layer in tm.encoder.layers:
            h = layer.layer_norm1(x)
            a = layer.self_attn

            def split(t):
                return t.reshape(b, n, self.heads, d).transpose(1, 2)

            q, k, v = (split(a.q_proj(h) * d ** -0.5), split(a.k_proj(h)),
                       split(a.v_proj(h)))
            sim = torch.matmul(self.attend.q(q),
                               self.attend.q(k).transpose(-1, -2)) + mask
            o = torch.matmul(self.attend.q(torch.softmax(sim, -1)),
                             self.attend.q(v))
            x = x + a.out_proj(o.transpose(1, 2).reshape(b, n, -1))
            h = layer.mlp.fc1(layer.layer_norm2(x))
            x = x + layer.mlp.fc2(h * torch.sigmoid(1.702 * h))
        return tm.final_layer_norm(x)


def build(kind: str, cfg: dict) -> nn.Module:
    """The reference module of ``kind`` ("unet_adapter", "unet",
    "control", "vae" or "clip") from a configuration file's sections."""
    if kind in ("unet_adapter", "unet"):
        p, a = cfg["unet"], cfg.get("adapter", {})
        return UNet(p["in_channels"], p["model_channels"], p["out_channels"],
                    p["num_res_blocks"], tuple(p["attention_resolutions"]),
                    tuple(p["channel_mult"]), p["num_heads"],
                    p["context_dim"], adapter=kind == "unet_adapter",
                    adapter_nums_rb=a.get("nums_rb", 2),
                    adapter_ksize=a.get("ksize", 1))
    if kind == "control":
        p = cfg["control"]
        return ControlNet(p["in_channels"], p["model_channels"],
                          p["hint_channels"], p["num_res_blocks"],
                          tuple(p["attention_resolutions"]),
                          tuple(p["channel_mult"]), p["num_heads"],
                          p["context_dim"])
    if kind == "vae":
        p = cfg["vae"]
        dd = p["ddconfig"]
        return AutoencoderKL(p["embed_dim"], dd["ch"], tuple(dd["ch_mult"]),
                             dd["num_res_blocks"], dd["z_channels"])
    if kind == "clip":
        p = cfg["clip"]
        return CLIPText(p["vocab_size"], p["width"], p["layers"], p["heads"],
                        p["max_length"])
    raise ValueError(f"unknown model kind {kind!r}")
