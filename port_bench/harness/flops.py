"""Analytic FLOP and byte counts of the model, from the widths of a
configuration file alone, and the H100's peaks.

A FLOP is a multiply or an add: a product of an (M, K) by a (K, N) matrix
is 2 M K N. Counted: every convolution, linear layer and attention product
(q k^T and P V, 4 N M C over all heads), which is what the work needs.
Not counted: norms, activations, softmax, residual adds, ScaleU's Fourier
filter, UniFusion's grounding MLPs and its ConvNeXt (under 0.2 % of a
request): a count that leaves work out can only read low, never above the
peak. Labeled (instance-masked) attention counts only the kept pairs.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA's data sheet, at 700 W
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes per second


def conv(hw_out: int, cin: int, cout: int, k: int, groups: int = 1) -> float:
    return 2.0 * hw_out * cout * (cin // groups) * k * k


def linear(n: int, din: int, dout: int) -> float:
    return 2.0 * n * din * dout


def attention(n: int, m: int, c: int) -> float:
    """q k^T and P V over n queries and m keys of total width c."""
    return 4.0 * n * m * c


def attention_bytes(b: int, n: int, m: int, c: int, elem: int = 2, label_rows: int = 0) -> float:
    """Each input read once, the output written once: q (b, n, c), k and v
    (b, m, c), out (b, n, c), and (bits, open) int32 labels over
    `label_rows` positions a row."""
    return elem * b * (2 * n * c + 2 * m * c) + 8.0 * b * label_rows


def plan(cfg: dict):
    """(kind, in_ch, out_ch, ds) of every layer of openaimodel's walk."""
    mc = cfg["model_channels"]
    layers, chans = [("conv_in", cfg["in_channels"], mc, 1)], [mc]
    ch, ds = mc, 1
    mults = cfg["channel_mult"]
    for level, mult in enumerate(mults):
        for _ in range(cfg["num_res_blocks"]):
            layers.append(("res", ch, mult * mc, ds))
            ch = mult * mc
            if ds in cfg["attention_resolutions"]:
                layers.append(("attn", ch, ch, ds))
            chans.append(ch)
        if level != len(mults) - 1:
            layers.append(("down", ch, ch, ds))
            chans.append(ch)
            ds *= 2
    layers += [("res", ch, ch, ds), ("attn", ch, ch, ds), ("res", ch, ch, ds)]
    for level, mult in list(enumerate(mults))[::-1]:
        for i in range(cfg["num_res_blocks"] + 1):
            layers.append(("res", ch + chans.pop(), mc * mult, ds))
            ch = mc * mult
            if ds in cfg["attention_resolutions"]:
                layers.append(("attn", ch, ch, ds))
            if level and i == cfg["num_res_blocks"]:
                layers.append(("up", ch, ch, ds))
                ds //= 2
    return layers


def unet_forward(cfg: dict, rows: int, gate: float = 0.0, grounding_tokens: int = 0,
                 ctx_len: int = 77, kept_pairs: float | None = None,
                 attn_only: bool = False) -> float:
    """FLOPs of one UNet forward over `rows` latents of cfg["image_size"]².
    gate != 0 runs the fuser of every transformer block over the visual
    tokens and `grounding_tokens` grounding tokens; kept_pairs: the ds1
    fusers' kept (query, key) pairs summed over the rows (None: dense).
    attn_only: only the attention products (q k^T, P V)."""
    s = cfg["image_size"]
    mc = cfg["model_channels"]
    emb = 4 * mc
    depth = cfg["transformer_depth"]
    ctx = cfg["context_dim"]
    total = 0.0 if attn_only else linear(1, mc, emb) + linear(1, emb, emb)
    for kind, cin, cout, ds in plan(cfg):
        hw = (s // ds) ** 2
        if kind == "attn":
            total += _transformer(hw, cout, depth, ctx, ctx_len, gate, grounding_tokens,
                                  kept_pairs / rows if (ds == 1 and kept_pairs is not None)
                                  else None, attn_only)
        elif attn_only:
            continue
        elif kind == "conv_in":
            total += conv(hw, cin, cout, 3)
        elif kind == "res":
            total += conv(hw, cin, cout, 3) + conv(hw, cout, cout, 3) + linear(1, emb, cout)
            if cin != cout:
                total += conv(hw, cin, cout, 1)
        elif kind == "down":
            total += conv(hw // 4, cin, cout, 3)
        elif kind == "up":
            total += conv(hw * 4, cin, cout, 3)
    if not attn_only:
        total += conv(s * s, mc, cfg["out_channels"], 3)
    return rows * total


def _transformer(hw: int, c: int, depth: int, ctx: int, ctx_len: int, gate: float,
                 g: int, kept: float | None, attn_only: bool) -> float:
    """One spatial transformer over hw visual tokens of width c: proj_in,
    `depth` blocks (self-attention, the fuser when the gate is open,
    cross-attention over ctx_len tokens of width ctx, GEGLU FF of inner
    4c), proj_out. kept: the fuser's kept pairs of one row (None: dense)."""
    prod = attention(hw, hw, c) + attention(hw, ctx_len, c)
    mats = 6 * linear(hw, c, c) + 2 * linear(ctx_len, ctx, c) + 24.0 * hw * c * c
    if gate != 0.0:
        prod += attention(hw, hw + g, c) if kept is None else 4.0 * kept * c
        mats += (linear(g, ctx, c) + 2 * linear(hw, c, c) + 2 * linear(hw + g, c, c)
                 + 24.0 * hw * c * c)
    if attn_only:
        return depth * prod
    return depth * (prod + mats) + 2 * linear(hw, c, c)


def vae_decode(cfg: dict, rows: int, latent: int) -> float:
    """SD VAE decoder from a latent² to (8 latent)² pixels."""
    mults, ch, nrb = cfg["ch_mult"], cfg["ch"], cfg["num_res_blocks"]
    res = latent
    block_in = ch * mults[-1]
    total = conv(res * res, cfg["z_channels"], block_in, 3) + linear(res * res, cfg["embed_dim"],
                                                                     cfg["z_channels"])
    total += 2 * _vae_res(res * res, block_in, block_in) + _vae_attn(res * res, block_in)
    for level in reversed(range(len(mults))):
        out = ch * mults[level]
        for _ in range(nrb + 1):
            total += _vae_res(res * res, block_in, out)
            block_in = out
        if level != 0:
            res *= 2
            total += conv(res * res, block_in, block_in, 3)
    return rows * (total + conv(res * res, block_in, cfg["out_ch"], 3))


def _vae_res(hw: int, cin: int, cout: int) -> float:
    f = conv(hw, cin, cout, 3) + conv(hw, cout, cout, 3)
    return f + (conv(hw, cin, cout, 1) if cin != cout else 0.0)


def _vae_attn(hw: int, c: int) -> float:
    return 4 * linear(hw, c, c) + attention(hw, hw, c)


def text_encoder(cfg: dict, sequences: int) -> float:
    """A CLIP text tower over 77-token sequences (all layers, as the tower
    runs them)."""
    n, d, m = cfg["max_length"], cfg["hidden_size"], cfg["intermediate_size"]
    layer = 4 * linear(n, d, d) + attention(n, n, d) + linear(n, d, m) + linear(n, m, d)
    return sequences * cfg["num_hidden_layers"] * layer
