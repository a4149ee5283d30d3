"""The metric arithmetic: a rate to the last completion, the idle share on a synthetic trace, roofline and MFU on
hand-worked layers."""

import types

import pytest
import torch

from port_bench.harness import flops, readers, stats, trace
from port_bench.harness.context import Outcome


def test_rate_runs_to_the_last_completion():
    assert stats.rate(40, 10.0, 58.0) == pytest.approx(40 / 48)
    with pytest.raises(ValueError):
        stats.rate(1, 5.0, 5.0)


class _Ev:
    def __init__(self, name, start, dur, device=False, tid=1, corr=0):
        self._n, self._s, self._d, self._dev, self._t, self._c = name, start, dur, device, tid, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c


def test_idle_share_and_span_time_on_a_synthetic_trace():
    s = 1_000_000_000
    events = [
        _Ev("pb.attn", 0, 100, tid=1),
        _Ev("cudaLaunchKernel", 10, 5, tid=1, corr=1),
        _Ev("cudaLaunchKernel", 200, 5, tid=1, corr=2),
        _Ev("flash_fwd", 20, 300_000_000, device=True, corr=1),
        _Ev("gemm", 200_000_000, 300_000_000, device=True, corr=2),  # overlaps the first
        _Ev("cudaMemsetAsync", 650_000_000, 5, tid=2, corr=3),
        _Ev("memset", 700_000_000, 100_000_000, device=True, corr=3),
        _Ev("pb.attn", 0, 800_000_000, device=True, corr=1),  # a device-side range: not work
        _Ev("Optimizer.step", 0, 900_000_000, tid=1, corr=9),
        _Ev("Optimizer.step", 0, 900_000_000, device=True, corr=9),  # nor the optimizer's
    ]
    summ = trace.reduce(events, window_s=1.0)
    assert summ.busy_s == pytest.approx((500_000_000 - 20 + 100_000_000) / s)
    assert summ.span_device_s == {"attn": pytest.approx(0.3 - 20 / s)}
    assert summ.idle_gaps[0][0] == "host_python"
    assert summ.idle_gaps[0][1] == pytest.approx(0.2)
    out = Outcome(1, 0, {}, [], summary=summ)
    assert readers.device_idle(out) == pytest.approx(100 * (1 - summ.busy_s))


def test_roofline_and_mfu_on_hand_worked_layers():
    # a linear of 4096 rows from 320 to 2560 features: 2 * 4096 * 320 * 2560 FLOPs
    assert flops.linear(4096, 320, 2560) == 2 * 4096 * 320 * 2560
    # a 3x3 conv at 64x64 from 4 to 320 channels
    assert flops.conv(64 * 64, 4, 320, 3) == 2 * 4096 * 320 * 4 * 9
    # attention of 4096 queries over 77 keys at width 320: q k^T and P V
    assert flops.attention(4096, 77, 320) == 2 * (2 * 4096 * 77 * 320)
    summ = types.SimpleNamespace(window_s=2.0, busy_s=1.0, span_device_s={"attn": 0.5})
    work = 4096 * 4096 * 320 * 4.0 * 16  # 16 rows of ds1 self-attention
    nbytes = flops.attention_bytes(16, 4096, 4096, 320)
    out = Outcome(1, 0, {}, [], readings={"attn_flops": work, "attn_bytes": nbytes,
                                          "model_flops": 989e12}, summary=summ)
    least = max(work / 989e12, nbytes / 3.35e12)
    assert readers.roofline(out, "attn") == pytest.approx(100 * least / 0.5)
    assert readers.mfu(out) == pytest.approx(50.0)
    assert readers.roofline(out, "ff") is None  # nothing to read: left out


def test_unet_count_matches_a_hand_walk_of_a_one_level_unet():
    cfg = {"image_size": 8, "in_channels": 4, "out_channels": 4, "model_channels": 32,
           "channel_mult": [1], "num_res_blocks": 1, "attention_resolutions": [1],
           "transformer_depth": 1, "context_dim": 16}
    hw, c, emb = 64, 32, 128
    res = flops.conv(hw, c, c, 3) * 2 + flops.linear(1, emb, c)
    res_up = flops.conv(hw, 2 * c, c, 3) + flops.conv(hw, c, c, 3) + flops.linear(1, emb, c) \
        + flops.conv(hw, 2 * c, c, 1)
    st = (8 * flops.linear(hw, c, c) + 2 * flops.linear(77, 16, c) + 24 * hw * c * c
          + flops.attention(hw, hw, c) + flops.attention(hw, 77, c))
    want = (flops.linear(1, c, emb) + flops.linear(1, emb, emb) + flops.conv(hw, 4, c, 3)
            + res + st                      # input block
            + res + st + res                # middle
            + 2 * (res_up + st)             # two output blocks
            + flops.conv(hw, c, 4, 3))
    assert flops.unet_forward(cfg, 1) == pytest.approx(want)
