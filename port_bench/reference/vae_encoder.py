"""The SD VAE with its encoder, of the plain reference (the SDXL refiner's
VAE: the SD architecture at scale factor 0.13025), float32, NHWC.

Encoder: input conv, 4 down levels of 2 res blocks, each level but the
last ending in a stride-2 conv padded 0 before and 1 after on H and W (the
LDM encoder's asymmetric padding), the middle res / attention / res,
GroupNorm + SiLU, output conv to the diagonal Gaussian's moments, then
`quant_conv`. The refiner encodes in mode form: the mean times the scale
factor. The decoder is `vae.py`'s. Parameter names are the port's
`models/vae.py` with `encoder=True`.

Departures from the published model: none in the function; the encoder
is run in mode form (no posterior sample), as the refiner's img2img does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import core as nn
from port_bench.reference.config import VAEConfig
from port_bench.reference.vae import AutoencoderKL, Mid, ResBlock


class DownLevel(torch.nn.Module):
    def __init__(self, block_in, block_out, n_blocks, downsample, *, device=None):
        super().__init__()
        self.block = torch.nn.ModuleList()
        for _ in range(n_blocks):
            self.block.append(ResBlock(block_in, block_out, device=device))
            block_in = block_out
        if downsample:
            self.downsample = nn.Conv2d(block_in, block_in, 3, device=device)


class Encoder(torch.nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None):
        super().__init__()
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, device=device)
        self.down = torch.nn.ModuleList(
            DownLevel(cfg.ch * in_ch_mult[i], cfg.ch * mult, cfg.num_res_blocks,
                      i != len(cfg.ch_mult) - 1, device=device)
            for i, mult in enumerate(cfg.ch_mult))
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.mid = Mid(block_in, device=device)
        self.norm_out = nn.Norm(block_in, device=device)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, device=device)

    def forward(self, x):
        h = nn.conv2d(self.conv_in, x, padding=1)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = nn.conv2d(level.downsample, F.pad(h, (0, 0, 0, 1, 0, 1)), stride=2)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = nn.group_norm(self.norm_out, h, eps=1e-6, act="silu")
        return nn.conv2d(self.conv_out, h, padding=1)


class EncodingAutoencoderKL(AutoencoderKL):
    """post_quant_conv + decoder, encoder + quant_conv."""

    def __init__(self, cfg: VAEConfig, *, device=None):
        super().__init__(cfg, device=device)
        self.encoder = Encoder(cfg, device=device)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, device=device)


def vae_encode_mode(p: EncodingAutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """Image (B,H,W,3) in [-1, 1] -> the posterior's mean times the scale
    factor, (B,H/8,W/8,4)."""
    moments = nn.conv2d(p.quant_conv, p.encoder(x.float()))
    return moments.chunk(2, dim=-1)[0] * p.cfg.scale_factor
