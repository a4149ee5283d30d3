"""OpenCLIP ViT-bigG/14 text tower of the plain reference (the SDXL
refiner's conditioner), float32.

The published tower (open_clip `ViT-bigG-14`, as sgm's
`FrozenOpenCLIPEmbedder2` runs it for the refiner with layer "penultimate",
legacy False): 32 pre-LayerNorm layers of width 1280, 20 heads, erf GELU
MLP of 5120, causal attention, learned positions over 77 tokens. It gives
the penultimate hidden states (the residual stream before the last layer,
no final LayerNorm: the UNet's cross-attention context) and the pooled
output: the last layer's states through the final LayerNorm, taken at the
EOT token (the argmax of the ids) and multiplied by the bias-free text
projection. Built from the CLIP-L reference's layer (`clip_text.Layer`), so
parameter names are the port's `models/clip_text.py`.

Departures from the published model: the token ids come from the
benchmark's hash tokenizer (`tokenizer.py`; no BPE files), which keeps
CLIP's layout of [SOT, tokens, EOT] padded with EOT to 77.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from port_bench.reference import core as nn
from port_bench.reference.attention import multi_head_attention
from port_bench.reference.clip_text import Layer


@dataclass
class OpenCLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 20
    activation: str = "gelu"
    projection_dim: int = 1280


class OpenCLIPText(torch.nn.Module):
    def __init__(self, cfg: OpenCLIPTextConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.token_embedding = nn.param(torch.empty((cfg.vocab_size, d), device=device))
        self.position_embedding = nn.param(torch.empty((cfg.max_length, d), device=device))
        self.layers = torch.nn.ModuleList(Layer(cfg, device=device)
                                          for _ in range(cfg.num_hidden_layers))
        self.final_ln = nn.Norm(d, device=device)
        self.text_projection = nn.Linear(d, cfg.projection_dim, bias=False, device=device)


def apply_openclip(p: OpenCLIPText, input_ids: torch.Tensor) -> dict:
    """(B, 77) ids -> {penultimate (B,77,D), pooled (B,P)}, float32."""
    b, n = input_ids.shape
    table = p.token_embedding
    x = table[input_ids.clamp(0, table.shape[0] - 1)].float() + p.position_embedding[:n].float()
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, None]
    penultimate = None
    for i, layer in enumerate(p.layers):
        if i == len(p.layers) - 1:
            penultimate = x
        h = nn.layer_norm(layer.ln1, x)
        q, k, v = (nn.linear(lin, h) for lin in (layer.q, layer.k, layer.v))
        x = x + nn.linear(layer.out, multi_head_attention(q, k, v, p.cfg.num_attention_heads,
                                                          mask=causal))
        h = nn.layer_norm(layer.ln2, x)
        x = x + nn.linear(layer.fc2, nn.gelu(nn.linear(layer.fc1, h)))
    x = nn.layer_norm(p.final_ln, x)
    pooled = x[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
    return {"penultimate": penultimate, "pooled": nn.linear(p.text_projection, pooled)}
