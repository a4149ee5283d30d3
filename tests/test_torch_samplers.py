"""The port's DPM-Solver++(2M) and DDIM samplers against the JAX package's,
with one model function written in both frameworks and the same numpy
starting noise, float32 on the CPU: schedules equal, samples within 1e-5
(float32 operations in the same order; the toy model's tanh differs by an
ulp between the libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu.ops import schedules as jsched
from instancediffusion_tpu.samplers import ddim as jddim
from instancediffusion_tpu.samplers import dpm as jdpm
from instancediffusion_tpu.samplers.plms import gate_runs
from instancediffusion_tpu_torch.ops import schedules
from instancediffusion_tpu_torch.samplers import ddim, dpm

ALPHA_TYPE = [0.75, 0.0, 0.25]


def _diffusions():
    return (jsched.make_diffusion_schedule("linear", 1000, 0.00085, 0.012),
            schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012))


def _fns(calls):
    """eps = tanh(x) * t/1000 + 0.1 * gate, in both frameworks; the torch
    one records the gate of each call."""
    def torch_fn(x, t, gate):
        calls.append(gate)
        return torch.tanh(x) * (t.float() / 1000)[:, None, None, None] + 0.1 * gate

    def jax_fn(x, t, gate):
        return jnp.tanh(x) * (t.astype(jnp.float32) / 1000)[:, None, None, None] + 0.1 * gate

    return torch_fn, jax_fn


def _x0(seed):
    return np.random.default_rng(seed).standard_normal((2, 4, 4, 3)).astype(np.float32)


@pytest.mark.parametrize("steps", [4, 20])
def test_dpm_schedule_and_sample_match(steps):
    """4 steps: lower_order_final on (a first-order last step); 20 steps
    (the serving setting): off. Gate runs 1 then 0, one model call per
    step."""
    jd, pd = _diffusions()
    js = jdpm.make_dpm_schedule(jd, steps, ALPHA_TYPE)
    ps = dpm.make_dpm_schedule(pd, steps, ALPHA_TYPE)
    for field in ("ts", "alpha_s", "sigma_s", "sig_ratio", "amul", "r", "gates"):
        np.testing.assert_array_equal(getattr(ps, field), getattr(js, field), err_msg=field)
    calls = []
    torch_fn, jax_fn = _fns(calls)
    x0 = _x0(steps)
    ref = jdpm.dpm_sample(jax_fn, js, jnp.asarray(x0), static_gates=gate_runs(js.gates))
    out = dpm.dpm_sample(torch_fn, ps, torch.from_numpy(x0))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert calls == list(ps.gates)


@pytest.mark.parametrize("lower_order_final", [True, False])
def test_dpm_lower_order_final_matches(lower_order_final):
    jd, pd = _diffusions()
    js, ps = jdpm.make_dpm_schedule(jd, 10, ALPHA_TYPE), dpm.make_dpm_schedule(pd, 10, ALPHA_TYPE)
    torch_fn, jax_fn = _fns([])
    x0 = _x0(3)
    ref = jdpm.dpm_sample(jax_fn, js, jnp.asarray(x0), static_gates=gate_runs(js.gates),
                          lower_order_final=lower_order_final)
    out = dpm.dpm_sample(torch_fn, ps, torch.from_numpy(x0), lower_order_final=lower_order_final)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps", [4, 10, 25])
def test_dpm_is_exact_on_constant_eps(steps):
    """A constant-eps model's ODE has the closed form x_t = alpha_t c +
    sigma_t eps, c = (x_T - sigma_T eps) / alpha_T, which the 2M update
    integrates exactly (tests/test_dpm.py's anchor)."""
    _, pd = _diffusions()
    ps = dpm.make_dpm_schedule(pd, steps)
    eps = torch.from_numpy(_x0(7))
    x = torch.from_numpy(_x0(8))
    out = dpm.dpm_sample(lambda x, t, g: eps, ps, x)
    sig_f = float(ps.sig_ratio[-1] * ps.sigma_s[-1])
    c = (x - float(ps.sigma_s[0]) * eps) / float(ps.alpha_s[0])
    exact = float(np.sqrt(1.0 - sig_f ** 2)) * c + sig_f * eps
    torch.testing.assert_close(out, exact, rtol=0, atol=2e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_schedule_and_sample_match(eta):
    """eta 0: deterministic; eta 0.5: the per-step noise of JAX's
    split(PRNGKey(0), S) keys passed in."""
    jd, pd = _diffusions()
    steps = 5
    js = jddim.make_ddim_schedule(jd, steps, ALPHA_TYPE, eta=eta)
    ps = ddim.make_ddim_schedule(pd, steps, ALPHA_TYPE, eta=eta)
    for field in ("ts", "a_t", "a_prev", "sqrt_one_minus_a_t", "sigmas", "gates"):
        np.testing.assert_array_equal(getattr(ps, field), getattr(js, field), err_msg=field)
    assert (ps.sigmas > 0).all() == (eta > 0)
    calls = []
    torch_fn, jax_fn = _fns(calls)
    x0 = _x0(5)
    rng = jax.random.PRNGKey(0)
    ref = jddim.ddim_sample(jax_fn, js, jnp.asarray(x0), rng)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, x0.shape, jnp.float32)))
             for k in jax.random.split(rng, steps)]
    out = ddim.ddim_sample(torch_fn, ps, torch.from_numpy(x0), noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert calls == list(ps.gates)


def test_ddim_draws_its_noise_from_the_generator():
    _, pd = _diffusions()
    ps = ddim.make_ddim_schedule(pd, 5, eta=0.5)
    torch_fn, _ = _fns([])
    x0 = torch.from_numpy(_x0(6))
    run = lambda s: ddim.ddim_sample(torch_fn, ps, x0, torch.Generator().manual_seed(s))
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert (run(1) - run(2)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="steps"):
        ddim.ddim_sample(torch_fn, ps, x0, noise=[x0] * 4)
