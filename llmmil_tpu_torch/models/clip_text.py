"""CLIP text encoder ("the LLM") + CoOp learnable-prompt clinical encoder.

The CLIP text tower (ResidualAttentionBlock with QuickGELU, causal mask,
ln_final, EOT-pool through ``text_projection``) and the CoOp wrapper
(learnable context vectors spliced between the SOT prefix and the token
suffix).  Only the text side is built.  Modules and parameters carry OpenAI
CLIP's ``state_dict`` names (``transformer.resblocks.{i}.attn.in_proj_weight``
...), so a CLIP checkpoint's text side loads without renaming.  LayerNorms
run in fp32 regardless of the compute dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activations import quick_gelu
from ..ops.masked import masked_softmax
from .layers import Dense, LayerNorm32, normal_


@dataclass(frozen=True)
class CLIPTextConfig:
    """ViT-B/32 text tower hyperparameters."""
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512


class _CausalSelfAttention(nn.Module):
    """Causal self-attention with CLIP's in_proj/out_proj parameter layout."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Dense(width, width, dtype)

    def init_weights(self, generator) -> None:
        normal_(self.in_proj_weight,
                1.0 / math.sqrt(self.in_proj_weight.shape[1]), generator)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, x):
        b, n, w = x.shape
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(b, n, self.heads, w // self.heads
                             ).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(w // self.heads)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        attn = masked_softmax(attn, causal[None, None], dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, w)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.c_fc = Dense(width, 4 * width, dtype)
        self.c_proj = Dense(4 * width, width, dtype)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """ln_1 → causal MHA → +x; ln_2 → 4× MLP with QuickGELU → +x."""

    def __init__(self, width: int = 512, heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = _CausalSelfAttention(width, heads, dtype)
        self.ln_2 = LayerNorm32(width)
        self.mlp = _MLP(width, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, dtype)
            for _ in range(cfg.layers))

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


class CLIPTextEncoder(nn.Module):
    """Full text tower.  ``forward`` embeds token ids and encodes;
    ``encode_embedding`` skips the lookup (CoOp splices its own embeddings).
    EOT pooling = row at argmax(token id) @ text_projection.
    """

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg, dtype)
        self.ln_final = LayerNorm32(cfg.width)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.width, cfg.embed_dim))

    def init_weights(self, generator) -> None:
        w = self.cfg.width
        normal_(self.token_embedding.weight, w ** -0.5, generator)
        normal_(self.positional_embedding, 0.01, generator)
        normal_(self.text_projection, w ** -0.5, generator)

    def embed(self, tokens):
        return self.token_embedding(tokens).to(self.compute_dtype)

    def encode_embedding(self, x, eot_idx):
        """x: (B, T, width) token embeddings; eot_idx: (B,) EOT positions."""
        n = x.shape[1]
        x = x + self.positional_embedding[:n].to(x.dtype)
        x = self.ln_final(self.transformer(x))
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_idx]
        return pooled @ self.text_projection.to(pooled.dtype)

    def forward(self, tokens):
        """tokens: (B, T) int ids → (B, embed_dim)."""
        return self.encode_embedding(self.embed(tokens),
                                     tokens.argmax(dim=-1))


class CoOpClinicalEncoder(nn.Module):
    """CoOp-style clinical prompt encoder.

    ``learnable=True``: a (n_prompts, n_ctx, width) learnable context is
    spliced as [SOT-prefix | ctx | suffix] into the (frozen) token embeddings
    before the text transformer; gradients flow only into the context (the
    embedding lookup is detached).
    ``learnable=False``: plain no-grad ``encode_text`` per prompt row.

    Input tokens: (B, P, T); output: (B, P, embed_dim).
    """

    def __init__(self, n_prompts: int = 10, n_ctx: int = 8,
                 learnable: bool = True,
                 cfg: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_ctx = n_ctx
        self.learnable = learnable
        self.model = CLIPTextEncoder(cfg, dtype)
        if learnable:
            self.ctx = nn.Parameter(torch.empty(n_prompts, n_ctx, cfg.width))

    def init_weights(self, generator) -> None:
        if self.learnable:
            normal_(self.ctx, 0.02, generator)

    def forward(self, tokens):
        b, p, t = tokens.shape
        flat = tokens.reshape(b * p, t)
        if not self.learnable:
            with torch.no_grad():
                out = self.model(flat)
            return out.reshape(b, p, -1)

        emb = self.model.embed(flat).detach().reshape(b, p, t, -1)
        # the ctx table has one row per 'devided' prompt; the 'single'
        # version renders fewer prompts — use the first P rows
        ctx_b = self.ctx[:p][None].expand(b, -1, -1, -1).to(emb.dtype)
        spliced = torch.cat(
            [emb[:, :, :1], ctx_b, emb[:, :, 1 + self.n_ctx:]], dim=2)
        out = self.model.encode_embedding(
            spliced.reshape(b * p, t, -1), flat.argmax(dim=-1))
        return out.reshape(b, p, -1)
