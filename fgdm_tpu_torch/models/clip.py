"""Frozen CLIP text tower (ViT-L/14 text config), the cond stage, and its
tokenizer.

Counterpart of ``fgdm_tpu/models/clip.py``: ``CLIPAttention``,
``CLIPEncoderLayer`` and ``CLIPTextEncoder`` (``:34-106``): token and
position embeddings, pre-LN transformer layers with a causal mask and a
quick-GELU MLP, final LayerNorm, float32 ``[B, 77, 768]`` output.  The module
tree carries the HF ``CLIPTextModel`` names (``text_model.encoder.layers.N
.self_attn.q_proj`` ...), the key schema of
``fgdm_tpu/checkpoint/torch_export.py:export_clip``.  The 77-token attention
is the plain path (no kernel), as in the JAX package.

``CLIPTokenizer`` is the port's own copy of ``clip.py:112-246``: byte-level
BPE from ``vocab.json`` + ``merges.txt`` (``FGDM_CLIP_VOCAB_DIR``), or the
deterministic hash fallback when no vocabulary is present.
"""

from __future__ import annotations

import html
import json
import os
import re
import zlib
from typing import List, Optional, Sequence

import torch
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.nn.layers import Dense, Embed, LayerNorm32

__all__ = ["CLIPAttention", "CLIPEncoderLayer", "CLIPTextEncoder",
           "CLIPTokenizer"]


class CLIPAttention(nn.Module):
    def __init__(self, embed_dim: int = 768, num_heads: int = 12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype=dtype)

    def forward(self, x, causal_mask):
        b, n, c = x.shape
        d_head = c // self.num_heads

        def split(t):
            return t.reshape(b, n, self.num_heads, d_head).transpose(1, 2)

        q = split(self.q_proj(x) * d_head ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) + causal_mask
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, embed_dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(embed_dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, embed_dim, dtype=dtype)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h.float()).to(h.dtype)   # quick_gelu
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int = 768, num_heads: int = 12,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm32(embed_dim)
        self.self_attn = CLIPAttention(embed_dim, num_heads, dtype=dtype)
        self.layer_norm2 = LayerNorm32(embed_dim)
        self.mlp = CLIPMLP(embed_dim, embed_dim * mlp_ratio, dtype)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    """``input_ids [B, n]`` (n <= max_length) -> float32 ``[B, n, D]``."""

    def __init__(self, vocab_size: int = 49408, embed_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 max_length: int = 77, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        with torch.device(resolve_device(device)):
            tm = self.text_model = nn.Module()
            tm.embeddings = nn.Module()
            tm.embeddings.token_embedding = Embed(vocab_size, embed_dim)
            tm.embeddings.position_embedding = Embed(max_length, embed_dim,
                                                     zero_init=True)
            tm.encoder = nn.Module()
            tm.encoder.layers = nn.ModuleList([
                CLIPEncoderLayer(embed_dim, num_heads, dtype=dtype)
                for _ in range(num_layers)])
            tm.final_layer_norm = LayerNorm32(embed_dim)

    def forward(self, input_ids):
        tm = self.text_model
        n = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids).to(self.dtype)
             + tm.embeddings.position_embedding.weight[None, :n]
             .to(self.dtype))
        causal = torch.triu(torch.full((n, n), -torch.inf,
                                       device=x.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x).float()


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """Byte-level BPE tokenizer of openai/clip-vit-large-patch14.

    Reads ``vocab.json`` + ``merges.txt`` from ``vocab_dir`` or
    ``FGDM_CLIP_VOCAB_DIR``.  Without them it falls back to a deterministic
    hash of each pre-token into the non-special id range: stable ids and the
    right special tokens, but not CLIP's ids."""

    BOT = 49406
    EOT = 49407

    def __init__(self, vocab_dir: Optional[str] = None, max_length: int = 77):
        import regex

        self.max_length = max_length
        self._bpe_ranks = None
        self._encoder = None
        vocab_dir = vocab_dir or os.environ.get("FGDM_CLIP_VOCAB_DIR")
        if vocab_dir:
            self._load_vocab(vocab_dir)
        self._byte_encoder = _bytes_to_unicode()
        # CLIP's pre-tokenization pattern (needs regex's \p{L} / \p{N})
        self._pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
        self._cache = {}

    def check_production(self, context: str = "this run") -> None:
        """Refuse real weights with the hash fallback (its ids are not
        CLIP's) unless ``FGDM_ALLOW_HASH_TOKENIZER=1``."""
        if self.has_real_vocab:
            return
        if os.environ.get("FGDM_ALLOW_HASH_TOKENIZER") == "1":
            print("[tokenizer] WARNING: hash-fallback tokenizer with real "
                  f"weights in {context} (FGDM_ALLOW_HASH_TOKENIZER=1)")
            return
        raise SystemExit(
            f"[tokenizer] {context} loaded real model weights but no CLIP "
            "vocab is available — token ids would NOT match CLIP and output "
            "quality would silently degrade. Point FGDM_CLIP_VOCAB_DIR (or "
            "--vocab_dir) at a directory with vocab.json + merges.txt, or "
            "set FGDM_ALLOW_HASH_TOKENIZER=1 to proceed anyway.")

    def _load_vocab(self, vocab_dir: str):
        vpath = os.path.join(vocab_dir, "vocab.json")
        mpath = os.path.join(vocab_dir, "merges.txt")
        if os.path.exists(vpath) and os.path.exists(mpath):
            with open(vpath) as f:
                self._encoder = json.load(f)
            with open(mpath) as f:
                merges = f.read().split("\n")
            merges = [tuple(m.split()) for m in merges
                      if m and not m.startswith("#")]
            self._bpe_ranks = dict(zip(merges, range(len(merges))))

    @property
    def has_real_vocab(self) -> bool:
        return self._encoder is not None

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self._bpe_ranks.get(p, float("inf")))
            if bigram not in self._bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self._cache[token] = list(word)
        return list(word)

    def encode_text(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for tok in self._pat.findall(text):
            tok = "".join(self._byte_encoder[b] for b in tok.encode("utf-8"))
            if self._encoder is not None:
                ids.extend(self._encoder.get(piece, 0)
                           for piece in self._bpe(tok))
            else:
                ids.append(zlib.crc32(tok.encode("utf-8")) % 49000 + 1)
        return ids

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        """Padded ``[B, max_length]`` int64 ids: BOT, the text, EOT, EOT..."""
        out = torch.full((len(texts), self.max_length), self.EOT,
                         dtype=torch.int64)
        for i, t in enumerate(texts):
            ids = ([self.BOT] + self.encode_text(t)[: self.max_length - 2]
                   + [self.EOT])
            out[i, :len(ids)] = torch.tensor(ids, dtype=torch.int64)
        return out
