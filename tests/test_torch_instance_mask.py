"""The port's instance-mask functions against the JAX package's: box rasters
(rows indexed by x, round half to even), the dense fuser keep-mask, the
(bits, open) labels of the flash kernel and their dense form. Integer and
boolean outputs, so the comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu.kernels import flash_attention as jfa
from instancediffusion_tpu.ops import attention as jattn
from instancediffusion_tpu.ops import instance_mask as jim
from instancediffusion_tpu_torch.kernels import flash_attention as fa
from instancediffusion_tpu_torch.ops import attention as pattn
from instancediffusion_tpu_torch.ops import instance_mask as pim


def _boxes(rng, b, n):
    lo = rng.uniform(0, 0.6, (b, n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (b, n, 2))], -1).astype(np.float32)


def _rasters(rng, b, n, s, live):
    """Box rasters of `live` instances per sample, the rest zero (the
    pipeline multiplies rasters by the instance masks)."""
    r = np.array(jim.rasterize_boxes(jnp.asarray(_boxes(rng, b, n)), s))
    r[:, live:] = 0
    return r


@pytest.mark.parametrize("s", [8, 64])
def test_rasterize_boxes_matches(s):
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 2, 5)
    # bounds exactly on .5 pixel: round half to even in both libraries
    boxes[0, 0] = [0.5 / s, 1.5 / s, 2.5 / s, 5.5 / s]
    boxes[0, 1] = [0.0, 0.25, 1.0, 0.75]
    ref = np.asarray(jim.rasterize_boxes(jnp.asarray(boxes), s))
    out = pim.rasterize_boxes(torch.from_numpy(boxes), s).numpy()
    np.testing.assert_array_equal(out, ref)
    # rows indexed by x: box 1 spans all rows and the middle half of columns
    assert out[0, 1, :, 0].sum() == 0 and out[0, 1, 0, s // 2] == 1
    # half to even: x1 = 0.5 -> 0, y1 = 1.5 -> 2, x2 = 2.5 -> 2, y2 = 5.5 -> 6
    assert out[0, 0].sum() == 2 * 4 and out[0, 0, 0, 2] == 1 and out[0, 0, 2].sum() == 0


@pytest.mark.parametrize("drop", [False, True])
def test_build_fuser_mask_matches(drop):
    rng = np.random.default_rng(1)
    rasters = _rasters(rng, 3, 4, 8, live=2)
    rasters[2] = 0  # an all-zero sample (the CFG null half) is unmasked
    ref = np.asarray(jim.build_fuser_mask(jnp.asarray(rasters), drop, seg_tokens=5))
    out = pim.build_fuser_mask(torch.from_numpy(rasters), drop, seg_tokens=5).numpy()
    assert out.shape == (3, 1, 64 + 16 + 5, 64 + 16 + 5)
    np.testing.assert_array_equal(out, ref)
    assert out[2].all() and (out[0].all() == drop)


def test_instance_labels_match():
    rng = np.random.default_rng(2)
    rasters = _rasters(rng, 3, 4, 8, live=3)
    rasters[1] = 0  # fully open sample
    bits_j, open_j = jfa.instance_labels(jnp.asarray(rasters), 4, seg_tokens=5)
    bits, open_ = fa.instance_labels(torch.from_numpy(rasters), 4, seg_tokens=5)
    assert bits.dtype == open_.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    np.testing.assert_array_equal(open_.numpy(), np.asarray(open_j))
    assert fa.GROUNDING_BIT == jfa.GROUNDING_BIT
    assert open_[1].all() and not open_[0, :64].any()


def test_labels_to_dense_matches_and_equals_the_fuser_mask():
    """The dense form of the labels is the dense fuser mask (visual and
    box/point/scribble/polygon rows; the labels leave seg rows open)."""
    rng = np.random.default_rng(3)
    rasters = _rasters(rng, 2, 4, 8, live=3)
    bits, open_ = fa.instance_labels(torch.from_numpy(rasters), 4, seg_tokens=5)
    ref = np.asarray(jattn.labels_to_dense(jnp.asarray(bits.numpy()), jnp.asarray(open_.numpy())))
    out = pattn.labels_to_dense(bits, open_).numpy()
    np.testing.assert_array_equal(out, ref)
    dense = pim.build_fuser_mask(torch.from_numpy(rasters), seg_tokens=5).numpy()
    np.testing.assert_array_equal(out, dense)
