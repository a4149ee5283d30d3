"""The arithmetic the per-layer metric files share; each file in
`metrics/` binds one of these to its name. A reader returns None where the
run has nothing for it to read, and the metric is then left out."""

from __future__ import annotations

from port_bench.harness import flops


def device_idle(outcome) -> float | None:
    """Share of the traced window with nothing running on the card, %."""
    s = outcome.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(outcome) -> float | None:
    """Model FLOPs of the traced window's completed work over the window's
    seconds at the card's bf16 peak, %."""
    s = outcome.summary
    work = outcome.readings.get("model_flops")
    if s is None or not work:
        return None
    return 100.0 * work / (s.window_s * flops.PEAK_BF16_FLOPS)


def roofline(outcome, span: str) -> float | None:
    """The least time the card could take for the calls under the span (the
    larger of their FLOPs at the bf16 peak and their bytes at the HBM
    peak) over the device time of the kernels they launched, %."""
    s = outcome.summary
    work = outcome.readings.get(f"{span}_flops")
    device_s = s.span_device_s.get(span) if s is not None else None
    if not work or not device_s:
        return None
    least = max(work / flops.PEAK_BF16_FLOPS,
                outcome.readings[f"{span}_bytes"] / flops.PEAK_HBM_BYTES)
    return 100.0 * least / device_s


def reading(outcome, key: str) -> float | None:
    """A number the driver read from the program's own counters."""
    v = outcome.readings.get(key)
    return None if v is None else float(v)
