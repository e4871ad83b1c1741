"""SAM-style two-way cross-attention fusion.

``TwoWayTransformer`` / ``TwoWayAttentionBlock`` / downsampled ``Attention``
/ ``MLPBlock`` of the reference, with an optional key-validity mask on every
attention (the reference attends to zero-padded bag rows unmasked).  The
attention products are plain matmuls; the dynamic-int8 serving mode and the
``...2`` variants with image-side self-attention are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.masked import masked_softmax
from .layers import Dense, LayerNorm32


class MLPBlock(nn.Module):
    """lin2(relu(lin1(x)))."""

    def __init__(self, embedding_dim: int = 512, mlp_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lin1 = Dense(embedding_dim, mlp_dim, dtype)
        self.lin2 = Dense(mlp_dim, embedding_dim, dtype)

    def forward(self, x):
        return self.lin2(torch.relu(self.lin1(x)))


class Attention(nn.Module):
    """MHA with optional internal-dim downsampling plus key masking."""

    def __init__(self, embedding_dim: int = 512, num_heads: int = 8,
                 downsample_rate: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        internal = embedding_dim // downsample_rate
        if internal % num_heads:
            raise ValueError(f"num_heads={num_heads} must divide the "
                             f"internal dim {internal}")
        self.num_heads = num_heads
        self.q_proj = Dense(embedding_dim, internal, dtype)
        self.k_proj = Dense(embedding_dim, internal, dtype)
        self.v_proj = Dense(embedding_dim, internal, dtype)
        self.out_proj = Dense(internal, embedding_dim, dtype)

    def _heads(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q, k, v, key_mask=None):
        qh = self._heads(self.q_proj(q))
        kh = self._heads(self.k_proj(k))
        vh = self._heads(self.v_proj(v))
        if key_mask is not None:
            # zero masked value rows so non-finite padding can't poison
            # the attn @ v product through 0·NaN
            vh = vh.masked_fill(~key_mask[:, None, :, None], 0.0)
        attn = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        m = key_mask[:, None, None, :] if key_mask is not None else None
        attn = masked_softmax(attn, m, dim=-1)
        out = attn @ vh                                     # (B,H,Nq,dh)
        b, _, nq, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, -1))


class TwoWayAttentionBlock(nn.Module):
    """query self-attn → token→image cross → MLP → image→token cross."""

    def __init__(self, embedding_dim: int = 512, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(embedding_dim, num_heads, dtype=dtype)
        self.norm1 = LayerNorm32(embedding_dim)
        self.cross_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype)
        self.norm2 = LayerNorm32(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, dtype)
        self.norm3 = LayerNorm32(embedding_dim)
        self.norm4 = LayerNorm32(embedding_dim)
        self.cross_attn_image_to_token = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype)

    def forward(self, queries, keys, query_pe, key_pe,
                query_mask=None, key_mask=None):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries,
                                     key_mask=query_mask)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries,
                                               key_mask=query_mask)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        attn_out = self.cross_attn_token_to_image(q, k, keys,
                                                  key_mask=key_mask)
        queries = self.norm2(queries + attn_out)

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        attn_out = self.cross_attn_image_to_token(k, q, queries,
                                                  key_mask=query_mask)
        keys = self.norm4(keys + attn_out)
        return queries, keys


def tokens_from_feature_map(x: torch.Tensor, reduce: str) -> torch.Tensor:
    """5-D NDHWC CT feature map → token sequence.

    reduce='mean': (B,T,H,W,C) → (B,T,C) spatial mean (resnetMC3 path);
    reduce='flatten': (B,T,H,W,C) → (B,T·H·W,C) (medicalNet path).
    """
    if x.dim() != 5:
        return x
    if reduce == "mean":
        return x.mean(dim=(2, 3))
    b, t, h, w, c = x.shape
    return x.reshape(b, t * h * w, c)


class TwoWayTransformer(nn.Module):
    """Bidirectional cross-attention aligner.

    ``image_embedding``/``point_embedding`` may be (B, N, C) token streams or
    5-D NDHWC CT maps; 5-D inputs are tokenised per ``ct_reduce``.  The
    point side is the query side.  Returns (queries, keys).
    """

    def __init__(self, depth: int = 2, embedding_dim: int = 512,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, ct_reduce: str = "mean",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ct_reduce = ct_reduce
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0), dtype=dtype)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype)
        self.norm_final_attn = LayerNorm32(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding,
                image_mask=None, point_mask=None):
        image_embedding = tokens_from_feature_map(image_embedding,
                                                  self.ct_reduce)
        point_embedding = tokens_from_feature_map(point_embedding,
                                                  self.ct_reduce)
        if image_pe.dim() == 2:
            image_pe = image_pe[None]

        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe,
                                  query_mask=point_mask, key_mask=image_mask)

        q = queries + point_embedding
        k = keys + image_pe
        attn_out = self.final_attn_token_to_image(q, k, keys,
                                                  key_mask=image_mask)
        queries = self.norm_final_attn(queries + attn_out)
        return queries, keys
