"""Plain MLP as pure functions over pytree params.

Capability parity with the reference MLP (src/models.py:7-28): an
in -> hidden x (1 + hidden_layers) -> out ReLU stack with no activation on the
output layer.  Initialization matches torch.nn.Linear's default
(kaiming_uniform(a=sqrt(5)) == U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both
weights and biases) so training dynamics are comparable at fp32.

`apply` accepts a `compute_dtype` — params stay fp32 masters and are cast
per-matmul, so the whole stack runs in bf16 when enabled.
Weights are stored [in, out] (activations @ W), the natural layout for XLA.
"""

from __future__ import annotations

from typing import Any, List, Optional

import jax
import jax.numpy as jnp


def linear_init(
    key: jax.Array, in_features: int, out_features: int, init: str = "torch"
) -> dict:
    """init="torch": torch.nn.Linear default (U(+-1/sqrt(fan_in)) for both
    weight and bias) — reference parity, but its ReLU gain is ~1/6 per layer
    so deep stacks lose positional signal exponentially (measured ~3x decay
    per layer).  init="he": variance-preserving He-uniform weights + zero
    bias, for deep field MLPs."""
    wkey, bkey = jax.random.split(key)
    if init == "he":
        bound = jnp.sqrt(6.0 / in_features)
        return {
            "w": jax.random.uniform(
                wkey, (in_features, out_features), jnp.float32, -bound, bound
            ),
            "b": jnp.zeros((out_features,), jnp.float32),
        }
    bound = 1.0 / jnp.sqrt(jnp.float32(in_features))
    return {
        "w": jax.random.uniform(
            wkey, (in_features, out_features), jnp.float32, -bound, bound
        ),
        "b": jax.random.uniform(bkey, (out_features,), jnp.float32, -bound, bound),
    }


def linear_apply(params: dict, x: jax.Array, compute_dtype=jnp.float32) -> jax.Array:
    w = params["w"].astype(compute_dtype)
    b = params["b"].astype(compute_dtype)
    return jnp.dot(x.astype(compute_dtype), w, preferred_element_type=compute_dtype) + b


def mlp_init(
    key: jax.Array,
    in_features: int,
    hidden_features: int,
    hidden_layers: int,
    out_features: Optional[int] = None,
    init: str = "torch",
) -> List[dict]:
    """Layer list: in->hidden, then `hidden_layers` x hidden->hidden, then
    hidden->out (out defaults to hidden, as in the reference)."""
    out_features = out_features if out_features is not None else hidden_features
    dims = (
        [in_features]
        + [hidden_features] * (1 + hidden_layers)
        + [out_features]
    )
    keys = jax.random.split(key, len(dims) - 1)
    return [
        linear_init(k, d_in, d_out, init)
        for k, d_in, d_out in zip(keys, dims[:-1], dims[1:])
    ]


def mlp_apply(
    params: List[dict], x: jax.Array, compute_dtype=jnp.float32
) -> jax.Array:
    """ReLU between layers, identity on the output layer."""
    for layer in params[:-1]:
        x = jax.nn.relu(linear_apply(layer, x, compute_dtype))
    return linear_apply(params[-1], x, compute_dtype)


def mlp_apply_split(
    params: List[dict], pieces, compute_dtype=jnp.float32
) -> jax.Array:
    """mlp_apply(params, concat(pieces, -1)) WITHOUT the concat.

    A feature concat (e.g. [posenc 51 | dirs 3 | features 32]) materializes
    a copy of the full [n_samples, in] activation — and its transpose does
    it again in the backward.  Splitting
    the first layer into per-piece matmuls against row slices of W is
    mathematically the same contraction (equal up to f32 summation order)
    with no concat anywhere; the W row-slicing touches only the tiny weight
    matrix.
    """
    first = params[0]
    acc = None
    off = 0
    for p in pieces:
        w = first["w"][off : off + p.shape[-1]].astype(compute_dtype)
        # accumulate the partial contractions in f32: under bf16, per-piece
        # rounding + bf16 adds make the sum batch-shape-sensitive (packed vs
        # dense eval diverged ~1e-4), while one f32 tree is stable and at
        # least as accurate as the single fused dot
        term = jnp.dot(
            p.astype(compute_dtype), w, preferred_element_type=jnp.float32
        )
        acc = term if acc is None else acc + term
        off += p.shape[-1]
    assert off == first["w"].shape[0], (off, first["w"].shape)
    x = (acc + first["b"].astype(jnp.float32)).astype(compute_dtype)
    if len(params) == 1:
        return x
    x = jax.nn.relu(x)
    for layer in params[1:-1]:
        x = jax.nn.relu(linear_apply(layer, x, compute_dtype))
    return linear_apply(params[-1], x, compute_dtype)


def mlp_apply_split_per_ray(
    params: List[dict], ray_pieces, seg, pieces, compute_dtype=jnp.float32
) -> jax.Array:
    """`mlp_apply_split` where the LEADING first-layer pieces are constant
    per ray: their partial contraction is computed once per ray (n_rays
    rows) and row-gathered to the sample rows, instead of recomputing it at
    every sample.  `ray_pieces` are [n_rays, d_i] in first-layer weight
    order, `seg` maps sample row -> ray row, `pieces` are the remaining
    per-sample pieces.

    FORWARD-ONLY optimization (serving / eval): the gather's backward would
    be a cap-row segment reduction in place of one first-layer weight-grad
    matmul (tools/probe_posenc_ray.py), so the training path keeps
    `mlp_apply_split`.

    The per-ray partial sum stays f32 and is gathered as f32 rows, so the
    result matches `mlp_apply_split`'s f32 accumulation tree exactly up to
    matmul tiling (tested at 1e-5 on the sigmoid output).
    """
    first = params[0]
    off = 0
    acc_ray = None
    for p in ray_pieces:
        w = first["w"][off : off + p.shape[-1]].astype(compute_dtype)
        term = jnp.dot(
            p.astype(compute_dtype), w, preferred_element_type=jnp.float32
        )
        acc_ray = term if acc_ray is None else acc_ray + term
        off += p.shape[-1]
    acc = jnp.take(acc_ray, seg, axis=0)
    for p in pieces:
        w = first["w"][off : off + p.shape[-1]].astype(compute_dtype)
        acc = acc + jnp.dot(
            p.astype(compute_dtype), w, preferred_element_type=jnp.float32
        )
        off += p.shape[-1]
    assert off == first["w"].shape[0], (off, first["w"].shape)
    x = (acc + first["b"].astype(jnp.float32)).astype(compute_dtype)
    if len(params) == 1:
        return x
    x = jax.nn.relu(x)
    for layer in params[1:-1]:
        x = jax.nn.relu(linear_apply(layer, x, compute_dtype))
    return linear_apply(params[-1], x, compute_dtype)
