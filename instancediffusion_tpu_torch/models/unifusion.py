"""UniFusion grounding tokenizer (counterpart of
`instancediffusion_tpu/models/unifusion.py`): Fourier location encodings of
boxes, points, scribbles and polygons, each concatenated with the pooled
CLIP phrase embedding and pushed through its own 3-layer MLP, plus 64 seg
tokens from a ConvNeXt over the stacked instance masks. Output order
[box, point, scribble, polygon, seg]: 4*max_objs + 64 tokens (184 at the
SD1.5 config)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from instancediffusion_tpu_torch.config import UniFusionConfig
from instancediffusion_tpu_torch.models.convnext import ConvNeXt, apply_convnext_tiny
from instancediffusion_tpu_torch.nn import core as nn
from instancediffusion_tpu_torch.ops.schedules import fourier_embed


@dataclass
class ModalityDrops:
    """Which grounding modalities are dropped for this forward: Python
    bools, fixed at inference and drawn on the host once per training
    step."""

    drop_point: bool = False
    drop_box: bool = False
    drop_scribble: bool = False
    drop_polygons: bool = False
    drop_segs: bool = False

    @staticmethod
    def test_defaults(cfg: UniFusionConfig) -> "ModalityDrops":
        return ModalityDrops(
            drop_point=cfg.test_drop_points,
            drop_box=cfg.test_drop_boxes,
            drop_scribble=cfg.test_drop_scribbles,
            drop_polygons=cfg.test_drop_masks,
            drop_segs=cfg.test_drop_masks,
        )

    def resolve_keep_box(self) -> "ModalityDrops":
        """If every modality is dropped, keep boxes."""
        all_dropped = (self.drop_point and self.drop_box and self.drop_scribble
                       and self.drop_polygons and self.drop_segs)
        return ModalityDrops(self.drop_point, self.drop_box and not all_dropped,
                             self.drop_scribble, self.drop_polygons, self.drop_segs)


def train_modality_drops(u) -> ModalityDrops:
    """Per-batch training dropout from six uniforms in [0, 1): a 10 % drop
    per modality (u[0] box, u[1] point, u[2] scribble, u[3] polygons, segs
    with polygons), then the reference's hierarchy fix-ups: kept masks keep
    box and point, a kept box keeps point; 10 % point only (u[4]); 10 %
    seg only (u[5], if segs are kept): box, point, polygons and segs kept,
    scribbles dropped."""
    drop_box, drop_point, drop_scribble, drop_polygons = (float(x) < 0.1 for x in u[:4])
    drop_segs = drop_polygons
    keep_masks = not drop_polygons
    drop_box = drop_box and not keep_masks
    drop_point = drop_point and not (not drop_box or keep_masks)
    if float(u[4]) < 0.1:  # keep point only
        drop_point = False
        drop_box = drop_scribble = drop_polygons = drop_segs = True
    if float(u[5]) < 0.1 and not drop_segs:  # keep seg only
        drop_point = drop_box = drop_polygons = drop_segs = False
        drop_scribble = True
    return ModalityDrops(drop_point, drop_box, drop_scribble, drop_polygons, drop_segs)


def null_grounding(batch: int, max_objs: int, cfg: UniFusionConfig,
                   device=None, dtype=torch.float32) -> dict:
    """All-zeros grounding (CFG null): every token takes its null embedding."""
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return {
        "boxes": z(batch, max_objs, 4),
        "masks": z(batch, max_objs),
        "text_masks": z(batch, max_objs),
        "positive_embeddings": z(batch, max_objs, cfg.in_dim),
        "scribbles": z(batch, max_objs, cfg.n_scribble_points * 2),
        "polygons": z(batch, max_objs, cfg.n_polygon_points * 2),
        "segs": z(batch, max_objs, cfg.seg_resize_input, cfg.seg_resize_input),
        "points": z(batch, max_objs, 2),
    }


class MLP(torch.nn.Module):
    def __init__(self, in_dim, mid_dim, out_dim, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.l0 = nn.Linear(in_dim, mid_dim, **kw)
        self.l1 = nn.Linear(mid_dim, mid_dim, **kw)
        self.l2 = nn.Linear(mid_dim, out_dim, **kw)

    def forward(self, x):
        x = nn.silu(nn.linear(self.l0, x))
        x = nn.silu(nn.linear(self.l1, x))
        return nn.linear(self.l2, x)


def modality_dims(cfg: UniFusionConfig) -> dict[str, int]:
    return {
        "box": cfg.fourier_freqs * 2 * 4,
        "point": cfg.fourier_freqs * 2 * 2,
        "scribble": cfg.fourier_freqs_polygons * 2 * cfg.n_scribble_points * 2,
        "polygon": cfg.fourier_freqs_polygons * 2 * cfg.n_polygon_points * 2,
        "seg": cfg.convnext_feature_dim,
    }


class UniFusion(torch.nn.Module):
    def __init__(self, cfg: UniFusionConfig, *, generator=None, device=None):
        super().__init__()
        dims = modality_dims(cfg)
        kw = dict(generator=generator, device=device)
        zeros = lambda n: nn.param(torch.zeros(n, device=device))
        self.null_positive = zeros(cfg.in_dim)
        mlp = lambda d: MLP(d, cfg.mid_dim, cfg.out_dim, **kw)
        if cfg.train_add_boxes:
            self.mlp_box = mlp(cfg.in_dim + dims["box"])
            self.null_box = zeros(dims["box"])
        if cfg.train_add_points:
            self.mlp_point = mlp(cfg.in_dim + dims["point"])
            self.null_point = zeros(dims["point"])
        if cfg.train_add_scribbles:
            self.mlp_scribble = mlp(cfg.in_dim + dims["scribble"])
            self.null_scribble = zeros(dims["scribble"])
        if cfg.train_add_masks:
            self.mlp_polygon = mlp(cfg.in_dim + dims["polygon"])
            self.null_polygon = zeros(dims["polygon"])
            self.mlp_seg = mlp(dims["seg"])
            self.null_seg = zeros(dims["seg"])
            self.in_conv = nn.Conv2d(cfg.seg_channels, 3, 3, **kw)
            self.convnext = ConvNeXt(depths=cfg.convnext_depths,
                                     dims=cfg.convnext_dims, **kw)
            pos = torch.randn((1, cfg.num_seg_tokens, dims["seg"]),
                              generator=generator, device=device) * 0.02
            self.pos_embedding = nn.param(pos)


def num_grounding_tokens(cfg: UniFusionConfig, max_objs: int) -> int:
    n = sum(max_objs for flag in (cfg.train_add_boxes, cfg.train_add_points,
                                  cfg.train_add_scribbles, cfg.train_add_masks)
            if flag)
    return n + (cfg.num_seg_tokens if cfg.use_segs else 0)


def apply_unifusion(p: UniFusion, cfg: UniFusionConfig, g: dict,
                    drops: ModalityDrops) -> torch.Tensor:
    """-> grounding tokens (B, G, out_dim), computed in the dtype of
    g["positive_embeddings"]."""
    drops = drops.resolve_keep_box()
    boxes = g["boxes"]
    masks = g["masks"][..., None]  # (B, N, 1)
    pos_emb = g["positive_embeddings"]
    dtype = pos_emb.dtype
    cast = lambda t: t.to(dtype)
    pos_emb = pos_emb * masks + (1 - masks) * cast(p.null_positive)
    tokens = []

    def gate(mask_val, drop):
        return torch.zeros_like(mask_val) if drop else mask_val

    def branch(mlp, emb, m, null):
        emb = emb * m + (1 - m) * cast(null)
        return mlp(torch.cat([pos_emb, emb], dim=-1))

    if cfg.train_add_boxes:
        emb = cast(fourier_embed(boxes, cfg.fourier_freqs))
        tokens.append(branch(p.mlp_box, emb, gate(masks, drops.drop_box), p.null_box))
    if cfg.train_add_points:
        points = g.get("points")
        if points is None:
            points = (boxes[:, :, :2] + boxes[:, :, 2:]) / 2.0
        emb = cast(fourier_embed(points, cfg.fourier_freqs))
        tokens.append(branch(p.mlp_point, emb, gate(masks, drops.drop_point),
                             p.null_point))
    if cfg.train_add_scribbles:
        scribbles = g["scribbles"]
        emb = cast(fourier_embed(scribbles, cfg.fourier_freqs_polygons))
        m = cast((scribbles.sum(-1, keepdim=True) + masks) > 0)
        tokens.append(branch(p.mlp_scribble, emb, gate(m, drops.drop_scribble),
                             p.null_scribble))
    if cfg.train_add_masks:
        polygons = g["polygons"]
        emb = cast(fourier_embed(polygons, cfg.fourier_freqs_polygons))
        m = cast((polygons.sum(-1, keepdim=True) + masks) > 0)
        tokens.append(branch(p.mlp_polygon, emb, gate(m, drops.drop_polygons),
                             p.null_polygon))
    if cfg.use_segs:
        segs = g["segs"].permute(0, 2, 3, 1)  # NHWC, C = max_objs
        if segs.shape[1] != cfg.seg_resize_input:
            segs = nn.resize_nearest(segs, cfg.seg_resize_input)
        feat = nn.conv2d(p.in_conv, cast(segs).contiguous(), padding=1)
        feat = apply_convnext_tiny(p.convnext, feat)  # (B, 16, 16, 768)
        # reference reshape: (B,768,16,16) -> (B, 3072, 64) -> (B, 64, 3072)
        fb = feat.shape[0]
        feat = feat.permute(0, 3, 1, 2).reshape(fb, -1, cfg.num_seg_tokens)
        feat = feat.transpose(1, 2)
        m = cast(g["segs"].sum(dim=(1, 2, 3)) > 0)[:, None, None]
        m = gate(m, drops.drop_segs)
        seg_emb = feat * m + (1 - m) * cast(p.null_seg)
        seg_emb = seg_emb + cast(p.pos_embedding)
        tokens.append(p.mlp_seg(seg_emb))
    return torch.cat(tokens, dim=1)
