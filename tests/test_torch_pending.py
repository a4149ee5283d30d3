"""`generate(..., block=False)` and `PendingImages` on the port, held to
JAX's `tests/test_pipeline.py::test_generate_async_pipelined`: two
handles enqueued back to back, then fetched in order; each independent of
the other, "fetch" absent from the timings until fetch(), and the images
bit-equal to the port's blocking path (with and without the program cache)
and within one uint8 level of JAX's handles on the same bridged weights and
starting latents, the MIS program included. The pinned-buffer form of the
handle on the card is in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from instancediffusion_tpu.pipeline import PendingImages as JaxPendingImages
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline, PendingImages

from tests.test_torch_pipeline import pipes  # noqa: F401  (the bridged pipelines)

STEPS = 5


@pytest.mark.parametrize("aot", [False, True], ids=["eager", "aot"])
def test_generate_async_pipelined(pipes, tmp_path, aot):  # noqa: F811
    _, _, ppipe, meta = pipes
    pipe = InstanceDiffusionPipeline(ppipe.cfg, ppipe.unet, ppipe.vae, ppipe.clip,
                                     ppipe.tokenizer)
    if aot:
        pipe.enable_aot(str(tmp_path))
    blocking = pipe.generate(meta, num_images=2, steps=STEPS, mis=0.0, seed=1)
    h1 = pipe.generate(meta, num_images=2, steps=STEPS, mis=0.0, seed=1, block=False)
    h2 = pipe.generate(meta, num_images=2, steps=STEPS, mis=0.0, seed=2, block=False)
    assert isinstance(h1, PendingImages) and isinstance(h2, PendingImages)
    assert "fetch" not in h1.timings and "fetch" not in h2.timings
    assert h1.timings["dispatch"] >= 0.0
    a, b = h1.fetch(), h2.fetch()
    np.testing.assert_array_equal(a, blocking)
    assert not np.array_equal(a, b)
    assert h1.timings["fetch"] >= 0.0
    # the MIS program also returns a handle
    h3 = pipe.generate(meta, num_images=1, steps=STEPS, mis=0.4, seed=1, block=False)
    mis_blocking = pipe.generate(meta, num_images=1, steps=STEPS, mis=0.4, seed=1)
    np.testing.assert_array_equal(h3.fetch(), mis_blocking)
    if aot:
        assert len(pipe._aot.variants) == 2


@pytest.mark.parametrize("mis", [0.0, 0.4])
def test_handles_match_jax_handles(pipes, mis):  # noqa: F811
    """Two handles each side on the same starting latents: within one
    uint8 level of JAX's (fp32 summation order can move a value across a
    floor boundary)."""
    cfg, jpipe, ppipe, meta = pipes
    mc = cfg.model
    rng = np.random.default_rng(7)
    x = [rng.standard_normal((2, mc.image_size, mc.image_size, mc.in_channels))
         .astype(np.float32) for _ in range(2)]
    jh = [jpipe.generate(meta, num_images=2, steps=STEPS, mis=mis, compute_dtype=jnp.float32,
                         initial_latents=xi, block=False) for xi in x]
    ph = [ppipe.generate(meta, num_images=2, steps=STEPS, mis=mis, initial_latents=xi,
                         block=False) for xi in x]
    assert all(isinstance(h, JaxPendingImages) for h in jh)
    for j, p in zip(jh, ph):
        ref, out = j.fetch(), p.fetch()
        assert out.shape == ref.shape and out.dtype == np.uint8
        assert int(ref.max()) - int(ref.min()) > 10
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert not np.array_equal(ph[0].fetch(), ph[1].fetch())
