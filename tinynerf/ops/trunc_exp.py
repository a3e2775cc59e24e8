"""Truncated exponential: exp with a gradient-explosion guard.

Semantics parity with the reference's TruncatedExponential autograd Function
(reference src/models.py:42-55, itself credited to torch-ngp): the forward is
a plain exp, the backward computes g * exp(clamp(x, -15, 15)) so that one
sample with a huge pre-activation cannot blow up the whole gradient.

`clamp_forward` is a STATIC (trace-time) switch for the deviation-parity A/B:
True = this framework's forward clamp; False = the
reference's unclamped forward (src/models.py:47).  It is threaded from
TrainConfig.fwd_clamp through the decoder dataclasses — never a module
global — so two renderers traced in one process can differ.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _fwd_value(x, clamp_forward: bool):
    if clamp_forward:
        # the forward also clamps (the reference's does not): exp(15) ~ 3.3e6
        # is far past opaque for any step size, and an unclamped forward
        # overflows to inf under aggressive learning rates (observed),
        # poisoning the whole pipeline with NaNs
        return jnp.exp(jnp.clip(x, -15.0, 15.0))
    return jnp.exp(x)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def truncated_exp(x: jax.Array, clamp_forward: bool = True) -> jax.Array:
    return _fwd_value(x, clamp_forward)


def _trunc_exp_fwd(x, clamp_forward):
    return _fwd_value(x, clamp_forward), x


def _trunc_exp_bwd(clamp_forward, x, g):
    return (g * jnp.exp(jnp.clip(x, -15.0, 15.0)),)


truncated_exp.defvjp(_trunc_exp_fwd, _trunc_exp_bwd)
