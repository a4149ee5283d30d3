"""CLIP text transformers (counterpart of
`instancediffusion_tpu/models/clip_text.py`).

CLIP ViT-L/14 (`TextEncoderConfig`): 12 layers, d=768, 12 heads, quick-GELU
MLP, causal attention, learned positions over 77 tokens, final LayerNorm.
Returns the last hidden state (the UNet's cross-attention context) and the
pooled feature at the EOT token (argmax of the ids)."""

from __future__ import annotations

import torch

from port_bench.reference.config import TextEncoderConfig
from port_bench.reference import core as nn
from port_bench.reference.attention import multi_head_attention


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Layer(torch.nn.Module):
    def __init__(self, cfg: TextEncoderConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        d, m = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = nn.Norm(d, device=device)
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.out = nn.Linear(d, d, **kw)
        self.ln2 = nn.Norm(d, device=device)
        self.fc1 = nn.Linear(d, m, **kw)
        self.fc2 = nn.Linear(m, d, **kw)


class CLIPTextModel(torch.nn.Module):
    def __init__(self, cfg: TextEncoderConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        tok = torch.randn((cfg.vocab_size, d), generator=generator, device=device)
        pos = torch.randn((cfg.max_length, d), generator=generator, device=device)
        self.token_embedding = nn.param(tok * 0.02)
        self.position_embedding = nn.param(pos * 0.01)
        self.layers = torch.nn.ModuleList(
            Layer(cfg, generator=generator, device=device)
            for _ in range(cfg.num_hidden_layers)
        )
        self.final_ln = nn.Norm(d, device=device)


def apply_clip_text(p: CLIPTextModel, input_ids: torch.Tensor) -> dict:
    """(B, 77) int ids -> {last_hidden_state (B,77,D), pooler_output (B,D)}."""
    b, n = input_ids.shape
    heads = p.cfg.num_attention_heads
    # ids past the table take its last row, as JAX's clamping gather does
    # (the special tokens of the real vocabulary exceed reduced test tables)
    table = p.token_embedding
    x = table[input_ids.clamp(0, table.shape[0] - 1)] + p.position_embedding[:n]
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, None]
    for layer in p.layers:
        h = nn.layer_norm(layer.ln1, x)
        q, k, v = (nn.linear(lin, h) for lin in (layer.q, layer.k, layer.v))
        x = x + nn.linear(layer.out, multi_head_attention(q, k, v, heads, mask=causal))
        h = nn.layer_norm(layer.ln2, x)
        x = x + nn.linear(layer.fc2, quick_gelu(nn.linear(layer.fc1, h)))
    x = nn.layer_norm(p.final_ln, x)
    eot = input_ids.argmax(dim=-1)
    pooled = x[torch.arange(b, device=x.device), eot]
    return {"last_hidden_state": x, "pooler_output": pooled}
