"""SD1.5 UNet with UniFusion grounding, gated self-attention fuser and
ScaleU (counterpart of `instancediffusion_tpu/models/unet.py`).

Activations are NHWC (channels_last memory); the static layer plan from
`build_plan` drives both module construction and `apply_unet`, so parameter
names mirror the JAX parameter tree (`input_blocks.1.0.in_norm.weight` is
`params["input_blocks"][1][0]["in_norm"]["scale"]`).

The gate scale is a Python float per step: at gate 0 the fuser does not
run and the stock-SD first conv replaces the grounded one. `fuser_mask`
(instance-masked attention, `use_masked_att`) reaches the fuser at ds1 only,
as (bits, open) labels for the flash kernel or a dense keep-mask.

Training (`apply_unet(train=True)`) takes the differentiable flash kernels
with unscaled q; `remat=True` recomputes each res block and spatial
transformer in the backward (torch.utils.checkpoint), as the JAX package's
jax.checkpoint does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from instancediffusion_tpu_torch.config import UNetConfig
from instancediffusion_tpu_torch.kernels.flash_attention import flash_attention
from instancediffusion_tpu_torch.kernels.geglu_ff import ff_geglu, ff_geglu_plain
from instancediffusion_tpu_torch.kernels.head_layout import merge_proj, proj_split
from instancediffusion_tpu_torch.models import unifusion
from instancediffusion_tpu_torch.nn import core as nn
from instancediffusion_tpu_torch.ops.attention import flash_route, multi_head_attention
from instancediffusion_tpu_torch.ops.schedules import timestep_embedding


@dataclass(frozen=True)
class LayerSpec:
    kind: str          # "conv_in" | "res" | "attn" | "down" | "up"
    in_ch: int = 0
    out_ch: int = 0
    ds: int = 1


def build_plan(cfg: UNetConfig):
    """(input_blocks, middle_block, output_blocks) as lists of LayerSpec."""
    mc = cfg.model_channels
    input_blocks = [[LayerSpec("conv_in", cfg.in_channels, mc)]]
    input_block_chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [LayerSpec("res", ch, mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                layers.append(LayerSpec("attn", ch, ch, ds))
            input_blocks.append(layers)
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([LayerSpec("down", ch, ch)])
            input_block_chans.append(ch)
            ds *= 2
    middle_block = [LayerSpec("res", ch, ch), LayerSpec("attn", ch, ch, ds),
                    LayerSpec("res", ch, ch)]
    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            layers = [LayerSpec("res", ch + ich, mc * mult)]
            ch = mc * mult
            if ds in cfg.attention_resolutions:
                layers.append(LayerSpec("attn", ch, ch, ds))
            if level and i == cfg.num_res_blocks:
                layers.append(LayerSpec("up", ch, ch))
                ds //= 2
            output_blocks.append(layers)
    return input_blocks, middle_block, output_blocks


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ResBlock(torch.nn.Module):
    def __init__(self, in_ch, out_ch, emb_ch, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.in_norm = nn.Norm(in_ch, device=device)
        self.in_conv = nn.Conv2d(in_ch, out_ch, 3, **kw)
        self.emb_lin = nn.Linear(emb_ch, out_ch, **kw)
        self.out_norm = nn.Norm(out_ch, device=device)
        self.out_conv = nn.Conv2d(out_ch, out_ch, 3, zero=True, **kw)
        if in_ch != out_ch:
            self.skip_conv = nn.Conv2d(in_ch, out_ch, 1, **kw)

    def forward(self, x, emb):
        h = nn.conv2d(self.in_conv, nn.group_norm(self.in_norm, x, act="silu"), padding=1)
        emb_out = nn.linear(self.emb_lin, nn.silu(emb)).to(h.dtype)
        h = h + emb_out[:, None, None, :]
        h = nn.conv2d(self.out_conv, nn.group_norm(self.out_norm, h, act="silu"), padding=1)
        skip = nn.conv2d(self.skip_conv, x) if hasattr(self, "skip_conv") else x
        return skip + h


class MHA(torch.nn.Module):
    def __init__(self, query_dim, kv_dim, inner_dim, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.to_q = nn.Linear(query_dim, inner_dim, bias=False, **kw)
        self.to_k = nn.Linear(kv_dim, inner_dim, bias=False, **kw)
        self.to_v = nn.Linear(kv_dim, inner_dim, bias=False, **kw)
        self.to_out = nn.Linear(inner_dim, query_dim, **kw)


# Fused projection + head split / merge around the split-heads flash kernel
# (kernels/head_layout.py: proj_split, merge_proj) for head dims below 64
# (ds1, c=40), inference only. Off by default, as in the JAX package: the
# unfused route already reads and writes head views in place, so the fused
# kernels save no copy here (PERF.md has the A/B on the H100).
FUSED_PROJ = False


def _apply_mha_fused(p: MHA, x, kv, num_heads, kv_len=None, labels=None):
    """The FUSED_PROJ route: proj_split, split-heads flash attention,
    merge_proj."""
    c = p.to_q.weight.shape[0] // num_heads
    n, m = x.shape[1], kv.shape[1]
    dt = x.dtype
    # q pre-scaled by 1/sqrt(c); k/v padded by proj_split to its row tile
    # with zeroed rows, masked by kv_len
    (q,) = proj_split(x, ((p.to_q.weight * (c ** -0.5)).to(dt),), num_heads)
    k, v = proj_split(kv, (p.to_k.weight.to(dt), p.to_v.weight.to(dt)), num_heads)
    out = flash_attention(q, k, v, labels=labels, pre_scaled=True,
                          kv_len=m if kv_len is None else kv_len)
    return merge_proj(out, p.to_out.weight.to(dt), p.to_out.bias.to(dt))[:, :n]


def _apply_mha(p: MHA, x, kv, num_heads, impl, kv_len=None, mask=None, labels=None):
    c = p.to_q.weight.shape[0] // num_heads
    n, m = x.shape[1], kv.shape[1]
    if (FUSED_PROJ and c < 64
            and flash_route(impl, n, m, x.dtype, c, labels, mask) == "split"):
        return _apply_mha_fused(p, x, kv, num_heads, kv_len, labels)
    pre_scaled = impl == "kernel"
    if pre_scaled:
        # inference only: fold 1/sqrt(c) into the bias-free to_q weight, so
        # the kernel skips a scaling pass over the scores (the training
        # kernels take unscaled q and scale dq themselves)
        q = torch.nn.functional.linear(x, (p.to_q.weight * (c ** -0.5)).to(x.dtype))
    else:
        q = nn.linear(p.to_q, x)
    k = nn.linear(p.to_k, kv)
    v = nn.linear(p.to_v, kv)
    out = multi_head_attention(q, k, v, num_heads, mask=mask, labels=labels, impl=impl,
                               pre_scaled=pre_scaled, kv_len=kv_len)
    return nn.linear(p.to_out, out)


class FeedForward(torch.nn.Module):
    """GEGLU feed-forward: proj (dim -> 2*inner), out (inner -> dim)."""

    def __init__(self, dim, mult=4, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.proj = nn.Linear(dim, dim * mult * 2, **kw)
        self.out = nn.Linear(dim * mult, dim, **kw)


def _apply_ff_geglu(p: FeedForward, x):
    """`ff_geglu` picks the fused kernel or the unfused route by dtype and
    shape (`ff_fits`); `plain_kernels()` takes the fp32 plain version."""
    fn = ff_geglu if nn.kernels_enabled() else ff_geglu_plain
    dt = x.dtype
    return fn(x, p.proj.weight.to(dt), p.proj.bias, p.out.weight.to(dt), p.out.bias)


class Fuser(torch.nn.Module):
    """GatedSelfAttentionDense over [visual | grounding] tokens."""

    def __init__(self, query_dim, context_dim, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.linear = nn.Linear(context_dim, query_dim, **kw)
        self.attn = MHA(query_dim, query_dim, query_dim, **kw)
        self.ff = FeedForward(query_dim, **kw)
        self.norm1 = nn.Norm(query_dim, device=device)
        self.norm2 = nn.Norm(query_dim, device=device)
        self.alpha_attn = nn.param(torch.zeros((), device=device))
        self.alpha_dense = nn.param(torch.zeros((), device=device))


def _apply_fuser(p: Fuser, x, objs, num_heads, gate_scale, impl, fuser_mask=None):
    """x (B,N,C) visual tokens, objs (B,G,ctx) grounding tokens. The kv
    sequence [x | objs] is passed unpadded: the flash kernel masks its own
    ragged tail. fuser_mask: None, (bits, open) int32 (B,N+G) labels, or a
    dense (B,1,N+G,N+G) bool keep-mask."""
    n_visual = x.shape[1]
    mask, labels = ((None, fuser_mask) if isinstance(fuser_mask, tuple)
                    else (fuser_mask, None))
    if mask is not None:
        mask = mask[:, :, :n_visual, :]
    objs_p = nn.linear(p.linear, objs.to(x.dtype))
    cat = nn.layer_norm(p.norm1, torch.cat([x, objs_p], dim=1))
    # query only the visual rows (the grounding rows' outputs are discarded)
    attn_out = _apply_mha(p.attn, cat[:, :n_visual], cat, num_heads, impl, mask=mask,
                          labels=labels)
    g1 = (gate_scale * torch.tanh(p.alpha_attn.float())).to(x.dtype)
    x = x + g1 * attn_out
    g2 = (gate_scale * torch.tanh(p.alpha_dense.float())).to(x.dtype)
    return x + g2 * _apply_ff_geglu(p.ff, nn.layer_norm(p.norm2, x))


class TransformerBlock(torch.nn.Module):
    def __init__(self, dim, context_dim, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.attn1 = MHA(dim, dim, dim, **kw)
        self.attn2 = MHA(dim, context_dim, dim, **kw)
        self.ff = FeedForward(dim, **kw)
        self.norm1 = nn.Norm(dim, device=device)
        self.norm2 = nn.Norm(dim, device=device)
        self.norm3 = nn.Norm(dim, device=device)
        self.fuser = Fuser(dim, context_dim, **kw)

    def forward(self, x, context, objs, num_heads, gate_scale, impl, fuser_mask=None):
        """self-attn -> fuser (skipped at gate 0) -> cross-attn -> FF."""
        xn = nn.layer_norm(self.norm1, x)
        x = _apply_mha(self.attn1, xn, xn, num_heads, impl) + x
        if gate_scale != 0.0:
            x = _apply_fuser(self.fuser, x, objs, num_heads, gate_scale, impl, fuser_mask)
        x = _apply_mha(self.attn2, nn.layer_norm(self.norm2, x), context.to(x.dtype),
                       num_heads, impl) + x
        return _apply_ff_geglu(self.ff, nn.layer_norm(self.norm3, x)) + x


class SpatialTransformer(torch.nn.Module):
    def __init__(self, ch, context_dim, depth, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm = nn.Norm(ch, device=device)
        self.proj_in = nn.Conv2d(ch, ch, 1, **kw)
        self.blocks = torch.nn.ModuleList(
            TransformerBlock(ch, context_dim, **kw) for _ in range(depth))
        self.proj_out = nn.Conv2d(ch, ch, 1, zero=True, **kw)

    def forward(self, x, context, objs, num_heads, gate_scale, impl, fuser_mask=None):
        b, h, w, c = x.shape
        x_in = x
        x = nn.conv2d(self.proj_in, nn.group_norm(self.norm, x, eps=1e-6))
        x = x.reshape(b, h * w, c)
        for blk in self.blocks:
            x = blk(x, context, objs, num_heads, gate_scale, impl, fuser_mask)
        return nn.conv2d(self.proj_out, x.reshape(b, h, w, c)) + x_in


class ConvLayer(torch.nn.Module):
    """conv_in / down / up: one 3x3 conv under the key `conv`."""

    def __init__(self, in_ch, out_ch, *, generator=None, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, generator=generator, device=device)


class ScaleU(torch.nn.Module):
    """Per output block: b over the backbone channels, s a scalar gate on
    the skip's low frequencies; both enter as tanh(.) + 1."""

    def __init__(self, channels, *, device=None):
        super().__init__()
        self.b = nn.param(torch.zeros(channels, device=device))
        self.s = nn.param(torch.zeros(1, device=device))


class OutHead(torch.nn.Module):
    def __init__(self, ch, out_ch, *, generator=None, device=None):
        super().__init__()
        self.norm = nn.Norm(ch, device=device)
        self.conv = nn.Conv2d(ch, out_ch, 3, zero=True, generator=generator, device=device)


class TimeEmbed(torch.nn.Module):
    def __init__(self, mc, emb_ch, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.l1 = nn.Linear(mc, emb_ch, **kw)
        self.l2 = nn.Linear(emb_ch, emb_ch, **kw)


class UNet(torch.nn.Module):
    def __init__(self, cfg: UNetConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        input_plan, middle_plan, output_plan = build_plan(cfg)
        emb_ch = cfg.model_channels * 4

        def layer(spec: LayerSpec):
            if spec.kind == "res":
                return ResBlock(spec.in_ch, spec.out_ch, emb_ch, **kw)
            if spec.kind == "attn":
                return SpatialTransformer(spec.out_ch, cfg.context_dim,
                                          cfg.transformer_depth, **kw)
            return ConvLayer(spec.in_ch, spec.out_ch, **kw)

        self.time_embed = TimeEmbed(cfg.model_channels, emb_ch, **kw)
        self.input_blocks = torch.nn.ModuleList(
            torch.nn.ModuleList(layer(s) for s in blk) for blk in input_plan)
        self.middle_block = torch.nn.ModuleList(layer(s) for s in middle_plan)
        self.output_blocks = torch.nn.ModuleList(
            torch.nn.ModuleList(layer(s) for s in blk) for blk in output_plan)
        self.out = OutHead(cfg.model_channels, cfg.out_channels, **kw)
        # ScaleU scales the backbone channels of each output block's input,
        # which are its first layer's inputs less the skip's (skips pop in
        # reverse order of the input blocks)
        skip_chans = [blk[-1].out_ch for blk in input_plan][::-1]
        self.scaleu = torch.nn.ModuleList(
            ScaleU(blk[0].in_ch - ich, device=device)
            for blk, ich in zip(output_plan, skip_chans))
        self.position_net = unifusion.UniFusion(cfg.grounding_tokenizer, **kw)
        # stock SD1.5 first conv, swapped in while the gate is 0
        self.first_conv_sd = nn.Conv2d(cfg.in_channels, cfg.model_channels, 3, **kw)


# ---------------------------------------------------------------------------
# ScaleU Fourier filter
# ---------------------------------------------------------------------------


def fourier_filter(x: torch.Tensor, threshold: int, scale: torch.Tensor):
    """Low-frequency rescale of an NHWC tensor. For threshold 1 the FFT mask
    touches exactly the bins {0,-1} x {0,-1}, so the filter is a projection
    onto those four Fourier modes: x + (s - 1) * P(x),
    P(x) = Re[conj(A) (A^T x B) conj(B)^T] / (H*W)."""
    if threshold != 1:
        return _fourier_filter_fft(x, threshold, scale)
    xf = x.float()
    _, h, w, _ = x.shape
    pi2 = 2.0 * torch.pi

    def basis(n):
        r = torch.arange(n, dtype=torch.float32, device=x.device) * (pi2 / n)
        re = torch.stack([torch.ones_like(r), torch.cos(r)], dim=1)
        im = torch.stack([torch.zeros_like(r), -torch.sin(r)], dim=1)
        return re, im  # (n, 2 modes) real and imaginary parts

    a_re, a_im = basis(h)
    b_re, b_im = basis(w)
    t_re = torch.einsum("bhwc,hm->bmwc", xf, a_re)
    t_im = torch.einsum("bhwc,hm->bmwc", xf, a_im)
    in_re = (torch.einsum("bmwc,wn->bmnc", t_re, b_re)
             - torch.einsum("bmwc,wn->bmnc", t_im, b_im))
    in_im = (torch.einsum("bmwc,wn->bmnc", t_re, b_im)
             + torch.einsum("bmwc,wn->bmnc", t_im, b_re))
    u_re = (torch.einsum("hm,bmnc->bhnc", a_re, in_re)
            + torch.einsum("hm,bmnc->bhnc", a_im, in_im))
    u_im = (torch.einsum("hm,bmnc->bhnc", a_re, in_im)
            - torch.einsum("hm,bmnc->bhnc", a_im, in_re))
    proj = (torch.einsum("bhnc,wn->bhwc", u_re, b_re)
            + torch.einsum("bhnc,wn->bhwc", u_im, b_im)) / (h * w)
    return (xf + (scale.float() - 1.0) * proj).to(x.dtype)


def _fourier_filter_fft(x, threshold, scale):
    """General-threshold FFT path (reference formulation)."""
    xf = x.float()
    _, h, w, _ = x.shape
    x_freq = torch.fft.fftshift(torch.fft.fftn(xf, dim=(1, 2)), dim=(1, 2))
    crow, ccol = h // 2, w // 2
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    in_r = (rows >= crow - threshold) & (rows < crow + threshold)
    in_c = (cols >= ccol - threshold) & (cols < ccol + threshold)
    region = (in_r[:, None] & in_c[None, :])[None, :, :, None]
    x_freq = x_freq * torch.where(region, scale.float(), torch.ones((), device=x.device))
    out = torch.fft.ifftn(torch.fft.ifftshift(x_freq, dim=(1, 2)), dim=(1, 2)).real
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def apply_unet(p: UNet, cfg: UNetConfig, x, timesteps, context, grounding=None,
               gate_scale: float = 1.0, drops=None, precomputed_objs=None,
               fuser_mask=None, train: bool = False, remat: bool = False):
    """eps-prediction forward. x (B,H,W,4) NHWC, timesteps (B,), context
    (B,77,D). Grounding tokens come from `precomputed_objs` (B,G,D) or are
    computed from `grounding` (null grounding when None) under `drops`.
    Long attention goes to the flash kernel unless plain_kernels() is
    active; `train=True` takes its differentiable version. fuser_mask: the
    ds1 fusers' instance mask, (bits, open) int32 (B,N64+G) labels or a
    dense (B,1,N64+G,N64+G) bool keep-mask. remat: recompute every res
    block and spatial transformer in the backward (gradient
    checkpointing), with the gate scale static and the fuser mask passed
    as an argument."""
    use_kernels = nn.kernels_enabled()
    attn_impl = "plain"
    if cfg.efficient_attention and use_kernels:
        attn_impl = "kernel_train" if train else "kernel"
    gcfg = cfg.grounding_tokenizer
    gate_scale = float(gate_scale)
    if precomputed_objs is not None:
        objs = precomputed_objs
    else:
        if grounding is None:
            grounding = unifusion.null_grounding(x.shape[0], cfg.max_objs, gcfg,
                                                 device=x.device, dtype=x.dtype)
        if drops is None:
            drops = unifusion.ModalityDrops.test_defaults(gcfg)
        objs = unifusion.apply_unifusion(p.position_net, gcfg, grounding, drops)

    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = nn.linear(p.time_embed.l2, nn.silu(nn.linear(p.time_embed.l1, t_emb)))
    input_plan, middle_plan, output_plan = build_plan(cfg)

    def block(fn, *args):
        """fn(*args), recomputed in the backward under remat with the
        kernels switched as they are now."""
        if not remat:
            return fn(*args)

        def run(*a):
            with nn.kernels_set(use_kernels):
                return fn(*a)

        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)

    def run_layer(spec: LayerSpec, m, h):
        if spec.kind == "conv_in":
            conv = p.first_conv_sd if gate_scale == 0.0 else m.conv
            return nn.conv2d(conv, h, padding=1)
        if spec.kind == "res":
            return block(m, h, emb)
        if spec.kind == "attn":
            mask = fuser_mask if spec.ds == 1 else None
            return block(lambda h, ctx, ob, mask: m(h, ctx, ob, cfg.num_heads, gate_scale,
                                                    attn_impl, mask),
                         h, context, objs, mask)
        if spec.kind == "down":
            return nn.conv2d(m.conv, h, stride=2, padding=1)
        if spec.kind == "up":
            return nn.conv2d(m.conv, nn.upsample_nearest_2x(h), padding=1)
        raise ValueError(spec.kind)

    hs = []
    h = x
    for specs, mods in zip(input_plan, p.input_blocks):
        for spec, m in zip(specs, mods):
            h = run_layer(spec, m, h)
        hs.append(h)
    for spec, m in zip(middle_plan, p.middle_block):
        h = run_layer(spec, m, h)
    for specs, mods, su in zip(output_plan, p.output_blocks, p.scaleu):
        skip = hs.pop()
        h = h * (torch.tanh(su.b.float()) + 1.0).to(h.dtype)
        skip = fourier_filter(skip, threshold=1, scale=torch.tanh(su.s.float()) + 1.0)
        h = torch.cat([h, skip], dim=-1)
        for spec, m in zip(specs, mods):
            h = run_layer(spec, m, h)
    h = nn.group_norm(p.out.norm, h, act="silu")
    return nn.conv2d(p.out.conv, h, padding=1)
