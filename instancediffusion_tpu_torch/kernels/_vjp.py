"""Gradients of the norm and GEGLU kernels: forward through the kernel,
backward through autograd of the kernel's plain version, recomputed from the
saved inputs. That is the JAX package's custom VJP of the same kernels
(`instancediffusion_tpu/kernels/norms.py` and `geglu_ff.py`: backward =
autodiff of the unfused formula); it has no backward kernel for them.
"""

from __future__ import annotations

import torch


class PlainVJP(torch.autograd.Function):
    """apply(kernel, plain, *tensors): kernel(*tensors) forward; the
    cotangent goes through autograd of plain(*tensors). Both callables take
    the tensors only (bind other arguments with functools.partial)."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            y = ctx.plain(*xs)
            wrt = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, grad))
        return (None, None, *(next(grads) if n else None for n in needs))


def plain_vjp(kernel, plain, *tensors):
    """kernel(*tensors), differentiable through `plain` when autograd
    records this call; a bare kernel call otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return PlainVJP.apply(kernel, plain, *tensors)
    return kernel(*tensors)
