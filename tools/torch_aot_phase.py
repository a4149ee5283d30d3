"""Run `chip_smoke.py`'s aot phase alone on one CUDA card.

    python3 tools/torch_aot_phase.py

Builds the kernels, makes the smoke's pipeline (Config(), "box" preset,
densified random weights) and its masked MIS twin, runs the eager phases the
aot phase compares with (the mis=0 and mis=0.36 requests, DDIM and
img2img), then the aot phase: each variant captured as a
CUDA graph and replayed against the eager images, the LoRA merge, two
generate(block=False) handles, serve(aot_dir=), and two restarted processes
on the kept kernel library. Prints the phases' lines and the card's line.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.kernels import _build
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("torch_aot_phase: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.lib()
    cs.log(f"build: {time.perf_counter() - t0:.1f}s ({_build.BUILD_INFO.get('path')})")
    os.environ.setdefault("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    pipe = cs.smoke_pipeline(torch, dev)
    mcfg = apply_test_preset(Config(), "mask")
    mcfg = dataclasses.replace(mcfg, model=dataclasses.replace(mcfg.model, use_masked_att=True))
    mpipe = InstanceDiffusionPipeline(mcfg, pipe.unet, pipe.vae, pipe.clip, pipe.tokenizer)
    keep_slice, keep_mis, keep_i2i = {}, {}, {}
    cs.log(cs.phase_request(torch, pipe, card, "slice", cs.META, 0.0, cs.PLAIN_PATH,
                            keep=keep_slice)[0])
    cs.log(cs.phase_request(torch, mpipe, card, "mis", dict(cs.META, segs=cs.meta_segs()), 0.36,
                            cs.MIS_PATH, keep=keep_mis)[0])
    cs.log(cs.phase_ddim_img2img(torch, pipe, card, keep=keep_i2i)[0])
    eager = cs.aot_eager_inputs(keep_slice, keep_mis, keep_i2i)
    cs.log(cs.phase_aot(torch, pipe, mpipe, card, eager)[0])
    cs.log(f"torch_aot_phase: passed in {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
