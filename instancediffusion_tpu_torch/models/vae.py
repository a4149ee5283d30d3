"""SD1.5 VAE, NHWC (counterpart of `instancediffusion_tpu/models/vae.py`).

Decoder: post-quant conv, mid res/attn/res, 4 up levels of 3 res blocks
(+ nearest 2x upsample and conv), GroupNorm(32, eps 1e-6) + SiLU, output
conv. Encoder (built only when asked, for training): input conv, 4 down
levels of 2 res blocks (+ stride-2 conv with the reference's asymmetric
(0, 1) padding), mid res/attn/res, GroupNorm + SiLU, output conv to the
diagonal Gaussian's moments, then `quant_conv`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.config import VAEConfig
from instancediffusion_tpu_torch.nn import core as nn


class ResBlock(torch.nn.Module):
    def __init__(self, in_ch, out_ch, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = nn.Norm(in_ch, device=device)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, **kw)
        self.norm2 = nn.Norm(out_ch, device=device)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, **kw)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1, **kw)

    def forward(self, x):
        h = nn.group_norm(self.norm1, x, eps=1e-6, act="silu")
        h = nn.conv2d(self.conv1, h, padding=1)
        h = nn.group_norm(self.norm2, h, eps=1e-6, act="silu")
        h = nn.conv2d(self.conv2, h, padding=1)
        if hasattr(self, "nin_shortcut"):
            x = nn.conv2d(self.nin_shortcut, x)
        return x + h


class AttnBlock(torch.nn.Module):
    """Single-head spatial self-attention, fp32 softmax (plain: the JAX
    package leaves it to XLA)."""

    def __init__(self, ch, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm = nn.Norm(ch, device=device)
        self.q = nn.Conv2d(ch, ch, 1, **kw)
        self.k = nn.Conv2d(ch, ch, 1, **kw)
        self.v = nn.Conv2d(ch, ch, 1, **kw)
        self.proj_out = nn.Conv2d(ch, ch, 1, **kw)

    def forward(self, x):
        b, h, w, c = x.shape
        hn = nn.group_norm(self.norm, x, eps=1e-6)
        q, k, v = (nn.conv2d(m, hn).reshape(b, h * w, c) for m in (self.q, self.k, self.v))
        sim = torch.einsum("bnc,bmc->bnm", q.float(), k.float()) * (c ** -0.5)
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        out = torch.einsum("bnm,bmc->bnc", attn, v)
        return x + nn.conv2d(self.proj_out, out.reshape(b, h, w, c))


class UpLevel(torch.nn.Module):
    def __init__(self, block_in, block_out, n_blocks, upsample, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.block = torch.nn.ModuleList()
        for _ in range(n_blocks):
            self.block.append(ResBlock(block_in, block_out, **kw))
            block_in = block_out
        if upsample:
            self.upsample = nn.Conv2d(block_in, block_in, 3, **kw)


class Mid(torch.nn.Module):
    def __init__(self, ch, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.block_1 = ResBlock(ch, ch, **kw)
        self.attn_1 = AttnBlock(ch, **kw)
        self.block_2 = ResBlock(ch, ch, **kw)


class Decoder(torch.nn.Module):
    def __init__(self, cfg: VAEConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, **kw)
        self.mid = Mid(block_in, **kw)
        # built in reversed level order, stored finest-first
        up_rev = []
        for i_level in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            up_rev.append(UpLevel(block_in, block_out, cfg.num_res_blocks + 1,
                                  i_level != 0, **kw))
            block_in = block_out
        self.up = torch.nn.ModuleList(up_rev[::-1])
        self.norm_out = nn.Norm(block_in, device=device)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, **kw)

    def forward(self, z):
        h = nn.conv2d(self.conv_in, z, padding=1)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = nn.conv2d(level.upsample, nn.upsample_nearest_2x(h), padding=1)
        h = nn.group_norm(self.norm_out, h, eps=1e-6, act="silu")
        return nn.conv2d(self.conv_out, h, padding=1)


class DownLevel(torch.nn.Module):
    def __init__(self, block_in, block_out, n_blocks, downsample, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.block = torch.nn.ModuleList()
        for _ in range(n_blocks):
            self.block.append(ResBlock(block_in, block_out, **kw))
            block_in = block_out
        if downsample:
            self.downsample = nn.Conv2d(block_in, block_in, 3, **kw)


def _downsample(p: nn.Conv2d, x):
    """Stride-2 conv after padding 0 before and 1 after on H and W (the
    reference's asymmetric padding)."""
    b = None if p.bias is None else p.bias.to(x.dtype)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)), p.weight.to(x.dtype), b,
                 stride=2)
    return y.permute(0, 2, 3, 1)


class Encoder(torch.nn.Module):
    def __init__(self, cfg: VAEConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, **kw)
        self.down = torch.nn.ModuleList()
        for i_level, mult in enumerate(cfg.ch_mult):
            self.down.append(DownLevel(cfg.ch * in_ch_mult[i_level], cfg.ch * mult,
                                       cfg.num_res_blocks, i_level != len(cfg.ch_mult) - 1,
                                       **kw))
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.mid = Mid(block_in, **kw)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.norm_out = nn.Norm(block_in, device=device)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, **kw)

    def forward(self, x):
        h = nn.conv2d(self.conv_in, x, padding=1)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = _downsample(level.downsample, h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = nn.group_norm(self.norm_out, h, eps=1e-6, act="silu")
        return nn.conv2d(self.conv_out, h, padding=1)


class AutoencoderKL(torch.nn.Module):
    """post_quant_conv + decoder, and with `encoder=True` also encoder +
    quant_conv. The encoding half is drawn after the decoding half, so a
    seeded generator gives the decoder the same weights either way."""

    def __init__(self, cfg: VAEConfig, *, encoder: bool = False, generator=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.decoder = Decoder(cfg, **kw)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1, **kw)
        if encoder:
            self.encoder = Encoder(cfg, **kw)
            self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, **kw)


def _moments(p: AutoencoderKL, x: torch.Tensor):
    moments = nn.conv2d(p.quant_conv, p.encoder(x))
    return moments.chunk(2, dim=-1)


def vae_encode(p: AutoencoderKL, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Image (B,H,W,3) in [-1, 1] -> sampled scaled latent (B,H/8,W/8,4):
    mean + exp(logvar / 2) * noise, logvar clamped to [-30, 20], times the
    scale factor. `noise`: standard normal of the latent's shape, passed in
    (the training step draws it from its generator)."""
    mean, logvar = _moments(p, x)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return (mean + std * noise.to(mean.dtype)) * p.cfg.scale_factor


def vae_encode_mode(p: AutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """Deterministic (mode) encode: mean times the scale factor."""
    return _moments(p, x)[0] * p.cfg.scale_factor


def vae_decode(p: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """Scaled latent (B,h,w,4) -> image (B,H,W,3) in [-1, 1]."""
    z = z / p.cfg.scale_factor
    return p.decoder(nn.conv2d(p.post_quant_conv, z))
