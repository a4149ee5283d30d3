"""Analytic FLOP and byte counts of the SDXL refiner's refine, from the
widths of the configuration file and the traffic's sizes alone, by the
rules of `flops.py` (products 2 M K N, convolutions, attention 4 N M C;
norms, activations and residual adds not counted).

A refine of B images at S px: one OpenCLIP-bigG encode of 2 sequences, the
VAE encoder over B images at S px, int(steps * strength) refiner UNet
forwards over 2B latents of S/8 (classifier-free guidance as one batch),
and the VAE decoder over B latents.
"""

from __future__ import annotations

from port_bench.harness import flops


def unet_forward(cfg: dict, rows: int, latent: int) -> float:
    """One refiner UNet forward over `rows` latents of latent² (the SD
    UNet's walk without fusers, at depth `transformer_depth` everywhere),
    with the ADM vector's `label_emb` MLP."""
    emb = 4 * cfg["model_channels"]
    label = flops.linear(1, cfg["adm_in_channels"], emb) + flops.linear(1, emb, emb)
    return flops.unet_forward(dict(cfg, image_size=latent), rows) + rows * label


def vae_encode(cfg: dict, rows: int, size: int) -> float:
    """The SD VAE encoder from size² pixels to the moments at (size/8)²,
    with `quant_conv`."""
    mults, ch, nrb = cfg["ch_mult"], cfg["ch"], cfg["num_res_blocks"]
    res = size
    total = flops.conv(res * res, cfg["in_channels"], ch, 3)
    block_in = ch
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            total += flops._vae_res(res * res, block_in, ch * mult)
            block_in = ch * mult
        if level != len(mults) - 1:
            res //= 2
            total += flops.conv(res * res, block_in, block_in, 3)
    total += 2 * flops._vae_res(res * res, block_in, block_in) + flops._vae_attn(res * res,
                                                                                block_in)
    moments = 2 * cfg["z_channels"]
    total += flops.conv(res * res, block_in, moments, 3)
    total += flops.conv(res * res, moments, 2 * cfg["embed_dim"], 1)
    return rows * total


def text_encoder(cfg: dict, sequences: int) -> float:
    """OpenCLIP-bigG over 77-token sequences, all its layers, and the
    pooled output's projection."""
    return (flops.text_encoder(cfg, sequences)
            + sequences * flops.linear(1, cfg["hidden_size"], cfg["projection_dim"]))


def kept_steps(traffic: dict) -> int:
    return max(1, min(int(traffic["steps"] * traffic["strength"]), traffic["steps"]))


def refine(config: dict, traffic: dict) -> float:
    """Model FLOPs of one refine of the traffic's request."""
    c = config["config"]
    b, s = traffic["num_images"], traffic["image_size"]
    return (text_encoder(c["text_encoder"], 2) + vae_encode(c["autoencoder"], b, s)
            + kept_steps(traffic) * unet_forward(c["unet"], 2 * b, s // 8)
            + flops.vae_decode(c["autoencoder"], b, s // 8))


def ff_bytes(rows: int, c: int, inner: int, elem: int = 2) -> float:
    """Bytes of one GEGLU feed-forward call read or written once: x and the
    output (rows, c), w1 (2 inner, c) and w2 (c, inner), and the biases."""
    return elem * (2 * rows * c + 3 * inner * c + 2 * inner + c)
