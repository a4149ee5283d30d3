"""CLIP text transformers (counterpart of
`instancediffusion_tpu/models/clip_text.py`).

CLIP ViT-L/14 (`TextEncoderConfig`): 12 layers, d=768, 12 heads, quick-GELU
MLP, causal attention, learned positions over 77 tokens, final LayerNorm.
Returns the last hidden state (the UNet's cross-attention context) and the
pooled feature at the EOT token (argmax of the ids).

OpenCLIP ViT-bigG/14 (`OpenCLIPTextConfig`, the SDXL refiner's
conditioner): 32 layers, d=1280, erf GELU and a bias-free text projection.
It also returns the penultimate hidden state (the residual stream before
the last block, without the final LayerNorm: the refiner's cross-attention
context) and the projected pooled feature (its pooled conditioning)."""

from __future__ import annotations

import torch

from instancediffusion_tpu_torch.config import OpenCLIPTextConfig, TextEncoderConfig
from instancediffusion_tpu_torch.nn import core as nn
from instancediffusion_tpu_torch.ops.attention import multi_head_attention


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
    def __init__(self, cfg: TextEncoderConfig | OpenCLIPTextConfig, *, generator=None,
                 device=None):
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
        proj_dim = getattr(cfg, "projection_dim", None)
        if proj_dim:
            self.text_projection = nn.Linear(d, proj_dim, bias=False, generator=generator,
                                             device=device)


def apply_clip_text(p: CLIPTextModel, input_ids: torch.Tensor) -> dict:
    """(B, 77) int ids -> {last_hidden_state (B,77,D), pooler_output (B,D),
    penultimate_hidden_state (B,77,D)[, projected_pooled (B,P)]}; the last
    when the tower has a text projection."""
    b, n = input_ids.shape
    heads = p.cfg.num_attention_heads
    # ids past the table take its last row, as JAX's clamping gather does
    # (the special tokens of the real vocabulary exceed reduced test tables)
    table = p.token_embedding
    x = table[input_ids.clamp(0, table.shape[0] - 1)] + p.position_embedding[:n]
    # the residual stream is summed in fp32, each layer's input rounded to the
    # compute dtype: a bf16 stream would round at each of the tower's adds
    # (64 in bigG's 32 layers), the larger part of its outputs' error
    dt = x.dtype
    x = x.float()
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, None]
    act = quick_gelu if getattr(p.cfg, "activation", "quick_gelu") == "quick_gelu" else nn.gelu
    penultimate = None
    for i, layer in enumerate(p.layers):
        if i == len(p.layers) - 1:
            penultimate = x.to(dt)
        h = nn.layer_norm(layer.ln1, x).to(dt)
        q, k, v = (nn.linear(lin, h) for lin in (layer.q, layer.k, layer.v))
        x = x + nn.linear(layer.out, multi_head_attention(q, k, v, heads, mask=causal))
        h = nn.layer_norm(layer.ln2, x).to(dt)
        x = x + nn.linear(layer.fc2, act(nn.linear(layer.fc1, h)))
    x = nn.layer_norm(p.final_ln, x).to(dt)
    eot = input_ids.argmax(dim=-1)
    pooled = x[torch.arange(b, device=x.device), eot]
    out = {"last_hidden_state": x, "pooler_output": pooled,
           "penultimate_hidden_state": penultimate}
    if hasattr(p, "text_projection"):
        out["projected_pooled"] = nn.linear(p.text_projection, pooled)
    return out
