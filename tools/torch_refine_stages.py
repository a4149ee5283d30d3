"""Where the SDXL refiner's refine loses precision: each stage of the port
against the benchmark's float32 reference fed the same inputs, beside the
reference at float8 (the check's control) for the same stage.

    python3 tools/torch_refine_stages.py --seeds N [N ...] [--rows 1 6]
        [--out refine_stages.json]

On one seed's weights (`port_bench/harness/refiner.weights`, bf16 on the
card) and request 0's inputs of the `sdxl_refiner_512x8` cell, for the
chosen rows of the batch:

- text: OpenCLIP-bigG's penultimate states and projected pooled output of
  [prompt, negative];
- encode: the VAE encode (mode) latents;
- eps: one refiner UNet forward at the first kept timestep, both halves of
  classifier-free guidance, and the guided eps (combined in fp32, and as
  the port combines it, in the compute dtype);
- ddim: the latent after every DDIM step, from the same noised latent with
  the reference's conditioning;
- decode: the VAE decode of the reference's final latent, as images in
  [0, 1];
- refine: the whole public `refine` against the reference's, in uint8
  levels as the CLI writes them.

Each stage gives its relative error ||a - b|| / ||b|| (and, for images, the
mean |difference| in uint8 levels), for the program (bf16 on the card) and
for the control. `substitute` reruns the port's chain with one stage's
output taken from the reference, so each stage's share of the final error
shows. Prints one JSON object per seed; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench.drivers.refine import options, to_u8  # noqa: E402
from port_bench.harness import refiner, refiner_flops  # noqa: E402
from port_bench.reference import core, ddim as ref_ddim  # noqa: E402
from port_bench.reference.sdxl_refiner import apply_refiner_unet as ref_unet  # noqa: E402
from port_bench.reference.vae import vae_decode as ref_decode  # noqa: E402
from port_bench.reference.vae_encoder import vae_encode_mode as ref_encode  # noqa: E402

CELL = "sdxl_refiner_512x8"


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def levels(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).mean())


def cell_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    config = json.loads((ROOT / "port_bench" / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((ROOT / "port_bench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return config, traffic


class PortChain:
    """The port's refine, stage by stage, from its own modules, with any
    stage's output replaceable by the reference's (`subs`)."""

    def __init__(self, pipe, traffic):
        from instancediffusion_tpu_torch.models import clip_text, sdxl_refiner, vae
        from instancediffusion_tpu_torch.samplers import ddim
        from instancediffusion_tpu_torch import pipeline_refiner

        self.pipe, self.t = pipe, traffic
        self.clip_text, self.sdxl, self.vae, self.ddim = clip_text, sdxl_refiner, vae, ddim
        self.sched = pipeline_refiner._slice_schedule(
            ddim.make_ddim_schedule(pipe.diffusion, traffic["steps"]),
            refiner_flops.kept_steps(traffic))

    def text(self, prompt, negative):
        return self.pipe._encode([prompt, negative])

    def conditioning(self, ctx, pooled, h, w, b):
        t, dt = self.t, self.pipe.dtype
        rep = lambda x: x.expand(b, *x.shape[1:])
        ctx2 = torch.cat([rep(ctx[1:2]), rep(ctx[0:1])]).to(dt)
        y = torch.cat([
            self.sdxl.refiner_adm_vector(rep(pooled[1:2]), (h, w), (0, 0),
                                         t["negative_aesthetic_score"]),
            self.sdxl.refiner_adm_vector(rep(pooled[0:1]), (h, w), (0, 0), t["aesthetic_score"]),
        ]).to(dt)
        return ctx2, y

    def encode(self, x_img):
        return self.vae.vae_encode_mode(self.pipe.vae, x_img.to(self.pipe.dtype)).float()

    def eps(self, xt, tt, ctx2, y):
        x2 = torch.cat([xt, xt]).to(self.pipe.dtype)
        return self.sdxl.apply_refiner_unet(self.pipe.unet, x2, torch.cat([tt, tt]), ctx2, y)

    def model_fn(self, ctx2, y, b):
        gs = float(self.t["guidance_scale"])

        def fn(xt, tt, gate=0.0):
            e = self.eps(xt, tt, ctx2, y)
            e_u, e_c = e[:b], e[b:]
            return e_u + gs * (e_c - e_u)

        return fn

    def sample(self, x, ctx2, y, b, record=None):
        fn = self.model_fn(ctx2, y, b)
        if record is None:
            return self.ddim.ddim_sample(fn, self.sched, x)
        for i in range(self.sched.num_steps):  # one step at a time, states recorded
            one = self.pipe_slice(i)
            x = self.ddim.ddim_sample(fn, one, x)
            record.append(x.clone())
        return x

    def pipe_slice(self, i):
        import dataclasses

        s = self.sched
        sl = slice(i, i + 1)
        return dataclasses.replace(s, ts=s.ts[sl], a_t=s.a_t[sl], a_prev=s.a_prev[sl],
                                   sqrt_one_minus_a_t=s.sqrt_one_minus_a_t[sl],
                                   sigmas=s.sigmas[sl], gates=s.gates[sl])

    def decode(self, z):
        img = self.vae.vae_decode(self.pipe.vae, z.to(self.pipe.dtype))
        return (img.float() * 0.5 + 0.5).clamp(0.0, 1.0)


def one_seed(seed: int, rows: list[int], config: dict, traffic: dict, device="cuda") -> dict:
    """The stage table of one seed (on the CPU the port runs in float32:
    a rehearsal at tiny widths)."""
    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    w = refiner.weights(config, seed, dev, dtype)
    pipe = refiner.port(config, w, dtype)
    ref = refiner.reference(config, w, dev)
    del w
    req = refiner.request(seed, 0, traffic, dev)
    images = np.asarray(req.images, np.float32) / 255.0
    sel = images[rows]
    noise = torch.from_numpy(req.noise[rows]).to(dev)
    b, h, w_ = len(rows), images.shape[1], images.shape[2]
    chain = PortChain(pipe, traffic)
    x_img = torch.from_numpy(sel * 2.0 - 1.0).to(dev)
    sched = ref_ddim.img2img_schedule(ref.diffusion, traffic["steps"], traffic["strength"])
    gs = float(traffic["guidance_scale"])
    out = {"seed": seed, "rows": rows,
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}

    def ref_stages(mode):
        """The reference's text and encode outputs at one precision."""
        with core.fp32_matmuls(), core.precision(mode):
            enc = ref.encode([req.prompt, traffic["negative_prompt"]])
            z = ref_encode(ref.vae, x_img)
            return enc, z

    with torch.inference_mode():
        enc32, z32 = ref_stages("fp32")
        enc8, z8 = ref_stages("fp8")
        p_ctx, p_pooled = chain.text(req.prompt, traffic["negative_prompt"])
        out["text"] = {
            "penultimate": [rel(p_ctx, enc32["penultimate"]), rel(enc8["penultimate"],
                                                                  enc32["penultimate"])],
            "pooled": [rel(p_pooled, enc32["pooled"]), rel(enc8["pooled"], enc32["pooled"])]}
        p_z = chain.encode(x_img)
        out["encode"] = [rel(p_z, z32), rel(z8, z32)]

        # the conditioning of the reference, as the port casts it
        with core.fp32_matmuls():
            r_ctx, r_y = ref.conditioning(req.prompt, traffic["negative_prompt"], (h, w_),
                                          traffic["aesthetic_score"],
                                          traffic["negative_aesthetic_score"])
        rep = lambda x: x.expand(b, *x.shape[1:])
        ctx2_32 = torch.cat([rep(r_ctx[0:1]), rep(r_ctx[1:2])])
        y2_32 = torch.cat([rep(r_y[0:1]), rep(r_y[1:2])])
        p_ctx2, p_y2 = chain.conditioning(enc32["penultimate"], enc32["pooled"], h, w_, b)
        p_ctx2o, p_y2o = chain.conditioning(p_ctx, p_pooled, h, w_, b)
        out["y"] = [rel(p_y2o, y2_32), rel(p_y2, y2_32)]  # port's y; fp32 inputs cast

        t0, a0, _ = sched[0]
        xt = ref_ddim.noise_to(z32, noise, a0)
        tt = torch.full((b,), t0, dtype=torch.long, device=dev)
        p_raw = chain.eps(xt, tt, p_ctx2, p_y2)
        p_eps = p_raw.float()
        eps = {}
        for mode in ("fp32", "fp8"):
            with core.fp32_matmuls(), core.precision(mode):
                eps[mode] = ref_unet(ref.unet, torch.cat([xt, xt]), torch.cat([tt, tt]),
                                     ctx2_32, y2_32)
        guided = lambda e: e[:b] + gs * (e[b:] - e[:b])
        out["eps"] = {"uncond": [rel(p_eps[:b], eps["fp32"][:b]), rel(eps["fp8"][:b],
                                                                      eps["fp32"][:b])],
                      "cond": [rel(p_eps[b:], eps["fp32"][b:]), rel(eps["fp8"][b:],
                                                                    eps["fp32"][b:])],
                      "guided": [rel(guided(p_eps), guided(eps["fp32"])),
                                 rel(guided(eps["fp8"]), guided(eps["fp32"]))],
                      "guided_as_combined": rel(guided(p_raw).float(), guided(eps["fp32"])),
                      "rms": float(eps["fp32"].double().pow(2).mean().sqrt()),
                      "guided_rms": float(guided(eps["fp32"]).double().pow(2).mean().sqrt())}

        # DDIM from the same noised latent, the reference's conditioning
        steps_p = []
        x_p = chain.sample(xt, p_ctx2, p_y2, b, record=steps_p)
        lat = {}
        def ref_fn(xx, t_):
            return guided(ref_unet(ref.unet, torch.cat([xx, xx]), torch.cat([t_, t_]), ctx2_32,
                                   y2_32))

        for mode in ("fp32", "fp8"):
            with core.fp32_matmuls(), core.precision(mode):
                traj, x = [], xt
                for step in sched:
                    x = ref_ddim.ddim_sample(ref_fn, [step], x)
                    traj.append(x)
                lat[mode] = traj
        out["ddim"] = {"per_step": [[rel(a, c), rel(d, c)] for a, c, d in
                                    zip(steps_p, lat["fp32"], lat["fp8"])],
                       "latent_rms": float(lat["fp32"][-1].double().pow(2).mean().sqrt()),
                       "z_rms": float(z32.double().pow(2).mean().sqrt())}

        # decode of the reference's final latent
        z_fin = lat["fp32"][-1]
        p_img = chain.decode(z_fin)
        dec = {}
        for mode in ("fp32", "fp8"):
            with core.fp32_matmuls(), core.precision(mode):
                dec[mode] = (ref_decode(ref.vae, z_fin) * 0.5 + 0.5).clamp(0.0, 1.0)
        u8 = lambda x: to_u8(x.cpu().numpy())
        out["decode"] = {"rel": [rel(p_img, dec["fp32"]), rel(dec["fp8"], dec["fp32"])],
                         "u8": [levels(u8(p_img), u8(dec["fp32"])),
                                levels(u8(dec["fp8"]), u8(dec["fp32"]))],
                         "saturated": float(((dec["fp32"] <= 0) | (dec["fp32"] >= 1))
                                            .float().mean())}

        # the whole chain: the public refine, the mirror, and substitutions
        full = to_u8(pipe.refine(images, req.prompt, noise=req.noise, **options(traffic)))[rows]
        want = {}
        for mode in ("fp32", "fp8"):
            with core.fp32_matmuls(), core.precision(mode):
                want[mode] = to_u8(ref.refine(images, req.prompt, req.noise, rows,
                                              **options(traffic)))
        mirror = u8(chain.decode(chain.sample(
            ref_ddim.noise_to(p_z, noise, a0), p_ctx2o, p_y2o, b)))
        out["refine"] = {"u8": [levels(full, want["fp32"]), levels(want["fp8"], want["fp32"])],
                         "mirror_vs_refine": levels(mirror, full)}
        subs = {
            "ref_text": dict(ctx=p_ctx2, y=p_y2),
            "ref_encode": dict(z=z32),
            "ref_text_encode": dict(ctx=p_ctx2, y=p_y2, z=z32),
        }
        res = {}
        for name, s in subs.items():
            z = s.get("z", p_z)
            x0 = chain.sample(ref_ddim.noise_to(z, noise, a0), s.get("ctx", p_ctx2o),
                              s.get("y", p_y2o), b)
            res[name] = levels(u8(chain.decode(x0)), want["fp32"])
        res["ref_sample"] = levels(u8(chain.decode(z_fin)), want["fp32"])
        out["substitute"] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rows", type=int, nargs="+", default=[1, 6])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_refine_stages: needs a CUDA card", file=sys.stderr)
        return 3
    config, traffic = cell_files()
    results = []
    for seed in args.seeds:
        r = one_seed(seed, args.rows, config, traffic)
        print(json.dumps(r), flush=True)
        results.append(r)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
