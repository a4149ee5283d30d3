"""ConvNeXt-Tiny feature backbone, NHWC (counterpart of
`instancediffusion_tpu/models/convnext.py`): stem 4x4/s4 conv + LayerNorm,
3 downsample (LN + 2x2/s2 conv) stages, blocks of depthwise-7x7 -> LN ->
Linear(4x) -> GELU -> Linear -> layer-scale gamma, eps 1e-6 everywhere."""

from __future__ import annotations

import torch

from port_bench.reference import core as nn

TINY_DEPTHS = (3, 3, 9, 3)
TINY_DIMS = (96, 192, 384, 768)


class Block(torch.nn.Module):
    def __init__(self, dim, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.dwconv = nn.Conv2d(dim, dim, 7, groups=dim, **kw)
        self.norm = nn.Norm(dim, device=device)
        self.pwconv1 = nn.Linear(dim, 4 * dim, **kw)
        self.pwconv2 = nn.Linear(4 * dim, dim, **kw)
        self.gamma = nn.param(torch.full((dim,), 1e-6, device=device))

    def forward(self, x):
        inp = x
        x = nn.conv2d(self.dwconv, x, padding=3)
        x = nn.layer_norm(self.norm, x, eps=1e-6)
        x = nn.gelu(nn.linear(self.pwconv1, x))
        x = nn.linear(self.pwconv2, x)
        return inp + self.gamma.to(x.dtype) * x


class Downsample(torch.nn.Module):
    def __init__(self, dim_in, dim_out, *, generator=None, device=None):
        super().__init__()
        self.norm = nn.Norm(dim_in, device=device)
        self.conv = nn.Conv2d(dim_in, dim_out, 2, generator=generator, device=device)


class ConvNeXt(torch.nn.Module):
    """Headless ConvNeXt; depths/dims default to -T."""

    def __init__(self, in_chans=3, depths=TINY_DEPTHS, dims=TINY_DIMS, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stem_conv = nn.Conv2d(in_chans, dims[0], 4, **kw)
        self.stem_norm = nn.Norm(dims[0], device=device)
        self.downsample = torch.nn.ModuleList(
            Downsample(dims[i], dims[i + 1], **kw) for i in range(len(dims) - 1)
        )
        self.stages = torch.nn.ModuleList(
            torch.nn.ModuleList(Block(dims[i], **kw) for _ in range(depths[i]))
            for i in range(len(dims))
        )

    def forward(self, x):
        """(B, H, W, C_in) -> (B, H/(4*2^n_down), W/(4*2^n_down), dims[-1])."""
        return apply_convnext_tiny(self, x)


def apply_convnext_tiny(p: ConvNeXt, x):
    x = nn.conv2d(p.stem_conv, x, stride=4)
    x = nn.layer_norm(p.stem_norm, x, eps=1e-6)
    for blk in p.stages[0]:
        x = blk(x)
    for ds, stage in zip(p.downsample, list(p.stages)[1:]):
        x = nn.layer_norm(ds.norm, x, eps=1e-6)
        x = nn.conv2d(ds.conv, x, stride=2)
        for blk in stage:
            x = blk(x)
    return x
