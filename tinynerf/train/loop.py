"""Training / inference / evaluation driver.

Capability parity with the reference's run layer (src/run.py):
  * train()  — same hyperparameter schedule (bs_ratio scaling rule, Adam
    lr 1e-2 / eps 1e-15 / wd 1e-5, MultiStepLR x0.33 at {1/2, 3/4, 5/6,
    9/10} of steps, TV/L1 regs for K-Planes, occupancy updates every
    16*bs_ratio steps), same metric artifacts (metrics_train/eval/test.json,
    rendered PNGs, final checkpoint).
  * infer()  — full-image rendering in fixed ray chunks, PNG dumps.
  * evaluate() — MSE/PSNR (+ real SSIM, which the reference never fills in).

Static-shape redesign:
  * ONE jitted train step: batch sampling (device-side gather from the
    device-resident ray pool), marching, compaction, field+decoders, weights,
    loss, grads, optimizer update — all fused; zero host<->device traffic in
    the hot loop except scalar metrics fetched in batches.
  * The reference's dynamic constant-sample batching (accumulate ray batches
    until the packed sample count hits batch_size*n_samples, src/run.py:
    205-244) becomes BUCKETED CANDIDATE BATCHING: the fixed sample buffer
    keeps per-step FLOPs constant, and the host picks, from a small set of
    precompiled candidate-ray sizes {1,2,4,8,16}x batch_size, the largest
    whose expected demand (running average samples/ray, same estimator idea
    as the reference's projected_size) fits the buffer.  Static shapes, no
    recompiles beyond one per bucket.
  * Data parallelism over rays: the step body runs under shard_map on a 1-D
    mesh; each device samples rays from its local pool shard and compacts
    locally; loss numerator/denominator and grads are psum'd across devices.
    Parameters, optimizer state and the occupancy grid are replicated.
  * Checkpoint/resume of {params, opt state, occupancy state, step} — an
    upgrade over the reference's save-only final state_dict.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import asdict
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 stable API; the experimental alias is deprecated
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..core import (
    ContractionAABB,
    ContractionMip360,
    NerfRenderer,
    OccupancyGrid,
    OccupancyState,
    RayMarcherAABB,
    RayMarcherUnbounded,
)
from ..data import PoseSet, RayPool
from ..data.pipeline import sample_ray_batch
from ..models import make_model
from ..parallel import DATA_AXIS, make_mesh, shard_rays
from ..utils import save_png
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import TrainConfig
from .metrics import EvalMetrics, TrainMetrics, eval_metrics

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    class _NullBar:
        def __init__(self, iterable=None):
            self._iterable = iterable if iterable is not None else iter(())

        def __iter__(self):
            return iter(self._iterable)

        def set_postfix(self, **kw):
            pass

        def update(self, n=1):
            pass

    def tqdm(x=None, **kw):
        return _NullBar(x)


# --------------------------------------------------------------------- setup


def _remat_auto(cfg: TrainConfig, field) -> bool:
    """Rematerialize the field when its saved activations would take more
    than half of the device's memory: only the wide vanilla MLP comes close.
    Per sample and hidden layer it keeps the layer's float32 input and
    output for the backward (2 x 4 bytes x width).  Devices that report no
    memory limit (the CPU backend) never rematerialize."""
    if cfg.method != "vanilla":
        return False
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return False
    per_sample = field.hidden_layers * field.hidden_features * 2 * 4
    return cfg.sample_cap * per_sample > 0.5 * limit


def build_renderer(cfg: TrainConfig, scene_scale: float, bg_color) -> NerfRenderer:
    """Wire field/decoders/marcher/contraction/occupancy from config
    (reference wiring: src/run.py:130-182)."""
    field, sigma_dec, rgb_dec = make_model(
        cfg.method, fwd_clamp=cfg.fwd_clamp, field_scale=cfg.field_scale
    )

    if cfg.scene_type == "unbounded":
        marcher = RayMarcherUnbounded(
            n_samples=cfg.n_samples, near=cfg.near, far=1e5, uniform_range=scene_scale
        )
        contraction = ContractionMip360(order=float("inf"))
    elif cfg.scene_type == "aabb":
        marcher = RayMarcherAABB(cfg.aabb, n_samples=cfg.n_samples, near=cfg.near)
        contraction = ContractionAABB(cfg.aabb)
    else:
        raise NotImplementedError(f"Unknown scene type {cfg.scene_type!r}.")

    occupancy = OccupancyGrid.cube(
        cfg.occupancy_res,
        marcher.step_size,
        threshold=cfg.occupancy_threshold,
        decay=cfg.occ_decay,
        interp=cfg.occupancy_interp,
    )

    return NerfRenderer(
        field=field,
        sigma_decoder=sigma_dec,
        rgb_decoder=rgb_dec,
        marcher=marcher,
        contraction=contraction,
        occupancy=occupancy,
        bg_color=tuple(float(c) for c in bg_color) if bg_color is not None else None,
        early_termination=cfg.early_termination,
        compute_dtype=jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32,
        remat_field=(
            cfg.remat_field
            if cfg.remat_field is not None
            else _remat_auto(cfg, field)
        ),
        skip_steps=min(cfg.effective_skip_steps, cfg.n_samples),
    )


def _decay_mask(params, table_keys=frozenset(), mlp_keys=frozenset({"mlp"})) -> object:
    """Weight-decay mask: decay MLP/linear weights, NOT raw feature tables.

    The reference decays everything (torch Adam(weight_decay=1e-5)), but
    under Adam's per-parameter normalization a constant decay direction on a
    sparsely-supervised table cell steps at the full learning rate and
    flattens the tables (observed as field collapse).  Excluding embedding-
    like tables from decay is the standard remedy.

    Group membership is DECLARED by the field module (`field.table_keys` /
    `field.mlp_keys`) rather than matched on parameter-dict names: a future
    field whose params use an unanticipated key fails loudly here instead of
    silently decaying its tables — the exact failure mode this mask exists
    to prevent.  Decoder params (the "sigma"/"rgb" subtrees) are always
    MLP/linear weights and always decay.
    """
    if isinstance(params, dict) and "field" in params:
        undeclared = set(params["field"].keys()) - set(table_keys) - set(mlp_keys)
        if undeclared:
            raise ValueError(
                f"field params {sorted(undeclared)} are not declared in the "
                f"field's table_keys={sorted(table_keys)} or "
                f"mlp_keys={sorted(mlp_keys)}; declare them so the optimizer "
                f"classifies them deliberately"
            )

    def mask_entry(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys and keys[0] == "field":
            return not any(k in table_keys for k in keys[1:])
        return True

    return jax.tree_util.tree_map_with_path(mask_entry, params)


def lr_schedule(cfg: TrainConfig):
    """Piecewise-constant schedule with torch MultiStepLR semantics: gamma is
    applied once PER MILESTONE OCCURRENCE, so milestones that collapse to the
    same step at small `steps` compose multiplicatively."""
    steps = cfg.total_steps
    boundaries: Dict[int, float] = {}
    for m in cfg.lr_milestones:
        b = max(1, int(m * steps))
        boundaries[b] = boundaries.get(b, 1.0) * cfg.lr_gamma
    return optax.piecewise_constant_schedule(cfg.effective_lr, boundaries)


def _fused_adam(
    schedule,
    eps: float,
    weight_decay: float,
    decay_mask_fn,
    table_ratio: float,
    table_mask_fn,
    b1: float = 0.9,
    b2: float = 0.999,
) -> optax.GradientTransformation:
    """Single-pass Adam with in-grad weight decay, LR schedule and split
    table lr — semantically identical (same op order, same f32 math) to

        optax.chain(add_decayed_weights(wd, mask), scale_by_adam(eps),
                    scale_by_learning_rate(schedule),
                    [masked(scale(ratio), table_mask)])

    but computed in ONE tree_map so XLA emits one fused loop per leaf
    instead of materializing an intermediate update tree per transform.
    State is a plain ScaleByAdamState, so
    checkpoints hold {count, mu, nu} directly."""

    def init(params):
        return optax.ScaleByAdamState(
            count=jnp.zeros([], jnp.int32),
            mu=jax.tree_util.tree_map(jnp.zeros_like, params),
            nu=jax.tree_util.tree_map(jnp.zeros_like, params),
        )

    def update(grads, state, params):
        if params is None:
            raise ValueError("fused adam requires params")
        # optax ordering: the schedule reads the PRE-increment count
        # (scale_by_schedule), adam bias-corrects with the post-increment
        # one (scale_by_adam)
        lr = schedule(state.count)
        count = optax.safe_int32_increment(state.count)
        c1 = 1.0 - b1 ** count.astype(jnp.float32)
        c2 = 1.0 - b2 ** count.astype(jnp.float32)
        decay_leaf = decay_mask_fn(params)
        table_leaf = table_mask_fn(params)

        flat_g, treedef = jax.tree_util.tree_flatten(grads)
        flat = {
            "p": jax.tree_util.tree_leaves(params),
            "mu": jax.tree_util.tree_leaves(state.mu),
            "nu": jax.tree_util.tree_leaves(state.nu),
            "dec": jax.tree_util.tree_leaves(decay_leaf),
            "tab": jax.tree_util.tree_leaves(table_leaf),
        }
        ups, mus, nus = [], [], []
        for g, p, mu, nu, dec, tab in zip(
            flat_g, flat["p"], flat["mu"], flat["nu"], flat["dec"], flat["tab"]
        ):
            if weight_decay != 0.0 and dec:
                g = g + weight_decay * p
            mu = b1 * mu + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * (g * g)
            u = (mu / c1.astype(mu.dtype)) / (
                jnp.sqrt(nu / c2.astype(nu.dtype)) + eps
            )
            u = -lr.astype(u.dtype) * u
            if tab and table_ratio != 1.0:
                u = table_ratio * u
            ups.append(u)
            mus.append(mu)
            nus.append(nu)
        unflat = jax.tree_util.tree_unflatten
        return unflat(treedef, ups), optax.ScaleByAdamState(
            count=count, mu=unflat(treedef, mus), nu=unflat(treedef, nus)
        )

    return optax.GradientTransformation(init, update)


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """Adam + L2-in-grad weight decay + piecewise-constant LR schedule,
    matching torch Adam(weight_decay=...) + MultiStepLR semantics (decay
    masked off the feature tables — see _decay_mask).  Built as ONE fused
    transformation (_fused_adam) rather than an optax chain — same math,
    ~4x less optimizer-stage traffic at table-sized params."""
    schedule = lr_schedule(cfg)
    field, _, _ = make_model(cfg.method)
    mask_fn = partial(
        _decay_mask,
        table_keys=frozenset(field.table_keys),
        mlp_keys=frozenset(field.mlp_keys),
    )
    if cfg.decay_tables:
        decay_mask_fn = lambda p: jax.tree_util.tree_map(lambda _: True, p)
    else:
        decay_mask_fn = mask_fn

    lr_tables = cfg.effective_lr_tables
    if lr_tables is not None and lr_tables != cfg.effective_lr:
        # split lr: scale table updates by the ratio (the schedule's decay
        # milestones then apply to both groups); tables = everything the
        # decay mask classifies as non-MLP
        ratio = lr_tables / cfg.effective_lr

        def table_mask_fn(params):
            return jax.tree_util.tree_map(lambda m: not m, mask_fn(params))
    else:
        ratio = 1.0
        table_mask_fn = lambda p: jax.tree_util.tree_map(lambda _: False, p)

    return _fused_adam(
        schedule, cfg.adam_eps, cfg.weight_decay, decay_mask_fn, ratio,
        table_mask_fn,
    )


# ---------------------------------------------------------------- train step


def make_train_step(
    renderer: NerfRenderer,
    optimizer: optax.GradientTransformation,
    cfg: TrainConfig,
    mesh: Mesh,
    n_cand: int,
    deterministic: bool = False,
    march: str = "dense",
):
    """One compiled train step for a given candidate-ray count `n_cand`.

    Returns fn(params, opt_state, occ_state, pool_o, pool_d, pool_rgb, key)
    -> (params, opt_state, metrics-dict of replicated scalars); with
    march="skip" the step takes an extra `skip_grid` argument after
    occ_state (precomputed by renderer.skip_grid at each occupancy update).

    `deterministic=True` (tests only) replaces the per-device rng batch with
    each device's leading pool-shard rays and disables sample jitter, so a
    1-device and an N-device mesh see the exact same global batch — the seam
    the sharded-vs-single gradient-equality test uses.
    """
    n_dev = mesh.devices.size
    assert n_cand % n_dev == 0, "candidate rays must divide the mesh"
    local_cand = n_cand // n_dev
    assert cfg.sample_cap % n_dev == 0
    local_cap = cfg.sample_cap // n_dev
    use_skip = march == "skip"

    if (
        cfg.shard_bwd
        and cfg.shard_tables
        and n_dev > 1
        and getattr(renderer.field, "lookup_mode", None) == "fused"
        and hasattr(renderer.field, "shard_bwd_axis")
    ):
        # shard the fused backward's fine-gradient pullback over the mesh
        # (ops/interp.py _sharded_pullback); the step body below runs the
        # field inside shard_map over DATA_AXIS, which is what the sharded
        # VJP requires
        renderer = dataclasses.replace(
            renderer,
            field=dataclasses.replace(
                renderer.field, shard_bwd_axis=(DATA_AXIS, n_dev)
            ),
        )

    has_reg = cfg.method == "kplanes" and (
        cfg.tv_reg_alpha != 0.0 or cfg.l1_reg_alpha != 0.0
    )

    grid_specs = (P(),) if use_skip else ()

    def local_grads(params, occ_state, rest):
        """Per-device (inside shard_map) batch -> loss pieces + local grads.

        Returns device-LOCAL (num, den, n_filled, n_complete, grads); the
        caller chooses the reduction (psum vs psum_scatter)."""
        if use_skip:
            skip_grid, pool_o, pool_d, pool_rgb, key = rest
        else:
            skip_grid = None
            pool_o, pool_d, pool_rgb, key = rest
        if deterministic:
            rays_o, rays_d, rgbs = (
                pool_o[:local_cand], pool_d[:local_cand], pool_rgb[:local_cand]
            )
            krender = None
        else:
            ax = jax.lax.axis_index(DATA_AXIS)
            key = jax.random.fold_in(key, ax)
            kbatch, krender = jax.random.split(key)
            rays_o, rays_d, rgbs = sample_ray_batch(
                kbatch, pool_o, pool_d, pool_rgb, local_cand
            )

        def data_loss(p):
            out = renderer.render_packed(
                p, occ_state, rays_o, rays_d, local_cap, key=krender,
                march=march, skip_grid=skip_grid,
            )
            per_ray_mse = jnp.mean((out.rgb - rgbs) ** 2, axis=-1)
            num = jnp.sum(per_ray_mse * out.ray_valid)
            den = jnp.sum(out.ray_valid)
            return num, (
                den,
                out.n_samples.astype(jnp.float32),
                out.n_complete.astype(jnp.float32),
            )

        (num, (den, n_filled, n_complete)), grads = jax.value_and_grad(
            data_loss, has_aux=True
        )(params)
        return num, den, n_filled, n_complete, grads

    table_keys = frozenset(getattr(renderer.field, "table_keys", frozenset()))
    if cfg.shard_tables and n_dev > 1 and table_keys:
        return _make_zero_step(
            renderer, optimizer, cfg, mesh, local_grads, grid_specs,
            table_keys, n_dev, n_cand, has_reg, deterministic,
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()) + grid_specs
        + (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def data_grads(params, occ_state, *rest):
        num, den, n_filled, n_complete, grads = local_grads(
            params, occ_state, rest
        )
        num = jax.lax.psum(num, DATA_AXIS)
        den = jax.lax.psum(den, DATA_AXIS)
        n_filled = jax.lax.psum(n_filled, DATA_AXIS)
        n_complete = jax.lax.psum(n_complete, DATA_AXIS)
        grads = jax.lax.psum(grads, DATA_AXIS)
        scale = 1.0 / jnp.maximum(den, 1.0)
        loss = num * scale
        grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
        return loss, grads, den, n_filled, n_complete

    def step(params, opt_state, occ_state, *rest):
        loss, grads, rays_used, n_filled, n_complete = data_grads(
            params, occ_state, *rest
        )

        if has_reg:
            def reg_fn(p):
                r = cfg.tv_reg_alpha * renderer.field.loss_tv(p["field"])
                if cfg.l1_reg_alpha != 0.0:
                    r = r + cfg.l1_reg_alpha * renderer.field.loss_l1(p["field"])
                return r

            reg_val, reg_grads = jax.value_and_grad(reg_fn)(params)
            loss = loss + reg_val
            grads = jax.tree_util.tree_map(jnp.add, grads, reg_grads)

        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = {
            "loss": loss,
            "rays_used": rays_used,
            "fill": n_filled / cfg.sample_cap,
            "complete_frac": n_complete / n_cand,
        }
        if deterministic:
            # expose the (replicated, post-psum) grads so equality tests can
            # compare them across mesh sizes
            metrics["grads"] = grads
        return params, opt_state, metrics

    return jax.jit(step, donate_argnums=(0, 1))


def _make_zero_step(
    renderer, optimizer, cfg, mesh, local_grads, grid_specs,
    table_keys, n_dev, n_cand, has_reg, deterministic,
):
    """Sharded-table (ZeRO-1) variant of the train step (parallel/zero.py).

    Differences from the replicated step, all inside one shard_map body:
      - table grads ride ONE psum_scatter (each device receives the summed
        1/N flat slice) instead of a psum; MLP grads still psum;
      - the TV/L1 regularizer computes ROW-PARTITIONED per device
        (field.loss_tv_partial) and its grads join the data grads BEFORE
        the reduction, so the reduce sums the partials into the exact full
        regularizer gradient at 1/N the per-device compute;
      - Adam runs on the local (param, grad) slice view — moments sharded,
        optimizer work and memory divide by N;
      - updated table slices all_gather back into full replicated tables.
    Same total collective bytes as psum-DP (scatter + gather = all-reduce).
    Optimizer state must come from `init_opt_state` (global flat view)."""
    from ..parallel import zero

    def step(params, opt_state, occ_state, *rest):
        opt_specs = zero.spec_tree(opt_state, table_keys)

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), opt_specs, P()) + grid_specs
            + (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=(P(), opt_specs, P()),
            check_vma=False,
        )
        def body(params, opt_state, occ_state, *rest):
            ax = jax.lax.axis_index(DATA_AXIS)
            num, den, n_filled, n_complete, grads = local_grads(
                params, occ_state, rest
            )
            num = jax.lax.psum(num, DATA_AXIS)
            den = jax.lax.psum(den, DATA_AXIS)
            n_filled = jax.lax.psum(n_filled, DATA_AXIS)
            n_complete = jax.lax.psum(n_complete, DATA_AXIS)
            scale = 1.0 / jnp.maximum(den, 1.0)
            loss = num * scale
            grads = jax.tree_util.tree_map(lambda g: g * scale, grads)

            if has_reg:
                def reg_fn(p):
                    r = cfg.tv_reg_alpha * renderer.field.loss_tv_partial(
                        p["field"], ax, n_dev
                    )
                    if cfg.l1_reg_alpha != 0.0:
                        r = r + cfg.l1_reg_alpha * renderer.field.loss_l1_partial(
                            p["field"], ax, n_dev
                        )
                    return r

                reg_val, reg_grads = jax.value_and_grad(reg_fn)(params)
                loss = loss + jax.lax.psum(reg_val, DATA_AXIS)
                grads = jax.tree_util.tree_map(jnp.add, grads, reg_grads)

            gview = zero.reduce_grads(grads, table_keys, n_dev)
            pview = zero.local_view(params, table_keys, n_dev, ax)
            updates, opt_state = optimizer.update(gview, opt_state, pview)
            pview = optax.apply_updates(pview, updates)
            params = zero.unview(pview, params, table_keys)
            metrics = {
                "loss": loss,
                "rays_used": den,
                "fill": n_filled / cfg.sample_cap,
                "complete_frac": n_complete / n_cand,
            }
            if deterministic:
                metrics["grads"] = zero.unview(gview, grads, table_keys)
            return params, opt_state, metrics

        return body(params, opt_state, occ_state, *rest)

    return jax.jit(step, donate_argnums=(0, 1))


def init_opt_state(renderer, optimizer, cfg: TrainConfig, mesh: Mesh, params):
    """Optimizer-state init matching the step variant make_train_step picks:
    sharded-table runs need the global FLAT table view (parallel/zero.py);
    everything else is a plain optimizer.init."""
    table_keys = frozenset(getattr(renderer.field, "table_keys", frozenset()))
    if cfg.shard_tables and mesh.devices.size > 1 and table_keys:
        from ..parallel import zero

        return zero.sharded_opt_init(
            optimizer, params, table_keys, mesh.devices.size
        )
    return optimizer.init(params)


def make_occupancy_update(renderer: NerfRenderer, mesh: Optional[Mesh] = None):
    """Jitted occupancy sweep.

    With a mesh: grid x-slices are sharded over the data axis — each device
    evaluates the field on its own voxel slab (the slab's field eval is the
    expensive part) — and the slabs are all-gathered once inside the update
    so the returned state is replicated for the train steps that consume it.
    """
    occ = renderer.occupancy

    if mesh is None or mesh.devices.size == 1:
        def update(params, occ_state, key):
            return occ.update(
                occ_state, lambda x: renderer.sigma_fn(params, x), key
            )

        return jax.jit(update)

    n_dev = mesh.devices.size
    r0 = occ.size[0]
    assert r0 % n_dev == 0, "occupancy resolution must divide the mesh"

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def sharded_slabs(params, grid_slab, x_idx, keys, thr):
        new_slab = occ.update_slices(
            grid_slab, x_idx, keys, thr, lambda x: renderer.sigma_fn(params, x)
        )
        # all-gather ONCE here so consumers (train step, host metrics) see a
        # replicated grid instead of re-gathering it every subsequent step
        new_grid = jax.lax.all_gather(new_slab, DATA_AXIS, tiled=True)
        mean = jnp.mean(new_grid)
        return new_grid, mean

    def update(params, occ_state, key):
        thr = occ._threshold(occ_state)
        keys = jax.random.split(key, r0)
        new_grid, mean = sharded_slabs(
            params, occ_state.grid, jnp.arange(r0), keys, thr
        )
        return OccupancyState(grid=new_grid, mean=mean)

    return jax.jit(update)


# ------------------------------------------------------------------ inference


def make_render_chunk(renderer: NerfRenderer, mesh: Optional[Mesh] = None):
    """Jitted dense render of one fixed-size ray chunk.

    With a mesh, the chunk's ray axis is sharded over the data axis (the
    dense path is pure vectorized math — pjit partitions it with no
    collectives beyond the input scatter/output gather).
    """
    def render_chunk(params, occ_state, rays_o, rays_d):
        return renderer.render_dense(params, occ_state, rays_o, rays_d).rgb

    if mesh is None or mesh.devices.size == 1:
        return jax.jit(render_chunk)
    data_sh = NamedSharding(mesh, P(DATA_AXIS))
    repl = NamedSharding(mesh, P())
    return jax.jit(
        render_chunk,
        in_shardings=(repl, repl, data_sh, data_sh),
        out_shardings=data_sh,
    )


def make_render_chunk_packed(
    renderer: NerfRenderer,
    cap: int,
    mesh: Optional[Mesh] = None,
    march: str = "dense",
):
    """Jitted fixed-capacity packed render of one ray chunk — the serving
    path.  Reuses the training compaction (core/renderer.py:render_packed)
    at inference: the field MLPs run on exactly `cap` surviving samples
    instead of chunk*n_samples dense positions (~5% at converged occupancy),
    with empty-space-skip marching when `march="skip"` (pass the skip grid
    as the trailing argument).

    Returns fn(params, occ_state, rays_o, rays_d, *grid) -> (rgb [R, 3],
    ok [R] bool).  ok=False rays overflowed the cap or exhausted the skip
    scan budget — infer() re-renders exactly those through the dense path,
    so packed eval is an optimization, never an approximation.
    """
    use_grid = march == "skip"

    def render(local_cap, params, occ_state, rays_o, rays_d, *grid):
        out = renderer.render_packed(
            params, occ_state, rays_o, rays_d, local_cap,
            march=march, skip_grid=grid[0] if use_grid else None,
            # forward-only trace: per-RAY rgb direction branch
            # (tools/probe_posenc_ray.py)
            rgb_dir_branch="ray",
        )
        return out.rgb, out.ray_valid > 0.0

    if mesh is None or mesh.devices.size == 1:
        return jax.jit(partial(render, cap))

    n_dev = mesh.devices.size
    assert cap % n_dev == 0, "eval cap must divide the mesh"
    grid_specs = (P(),) if use_grid else ()
    return jax.jit(
        shard_map(
            partial(render, cap // n_dev),
            mesh=mesh,
            in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS)) + grid_specs,
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            check_vma=False,
        )
    )


def infer(
    renderer: NerfRenderer,
    params,
    occ_state,
    dataset: PoseSet,
    indices: Sequence[int],
    folder: Path,
    name: str,
    chunk: int = 8192,
    render_chunk_fn=None,
    packed_fn=None,
    grid_args: Tuple = (),
) -> List[np.ndarray]:
    """Render full images pose-by-pose in fixed-size ray chunks, save PNGs
    `{name}_{i:04d}.png` (reference infer(), src/run.py:15-50)."""
    if render_chunk_fn is None:
        render_chunk_fn = make_render_chunk(renderer)
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)

    rendered: List[np.ndarray] = []
    for i in indices:
        item = dataset[i]
        K = dataset.img_intrinsics(i)
        rays_o = np.asarray(item["rays_o"]).reshape(-1, 3)
        rays_d = np.asarray(item["rays_d"]).reshape(-1, 3)
        n = rays_o.shape[0]
        n_pad = (-n) % chunk
        if n_pad:
            rays_o = np.concatenate([rays_o, np.zeros((n_pad, 3), np.float32)])
            rays_d = np.concatenate(
                [rays_d, np.tile(np.array([[0, 0, 1]], np.float32), (n_pad, 1))]
            )
        # dispatch every chunk before materializing any (JAX's async
        # dispatch pipelines the chunks; a per-chunk host fetch would stall
        # compute on the device-to-host round trip)
        chunks = []
        for k in range(0, rays_o.shape[0], chunk):
            o_c = jnp.asarray(rays_o[k : k + chunk])
            d_c = jnp.asarray(rays_d[k : k + chunk])
            if packed_fn is not None:
                rgb_d, ok_d = packed_fn(params, occ_state, o_c, d_c, *grid_args)
                chunks.append((rgb_d, ok_d, o_c, d_c))
            else:
                chunks.append(
                    (render_chunk_fn(params, occ_state, o_c, d_c), None, None,
                     None)
                )
        outs = []
        for rgb_d, ok_d, o_c, d_c in chunks:
            rgb = np.asarray(rgb_d)
            if ok_d is not None:
                ok = np.asarray(ok_d)
                if not ok.all():
                    # exact fallback: re-render overflow/incomplete rays
                    # through the dense path, padded to the same static
                    # chunk shape (at most one extra compile per shape)
                    bad = np.nonzero(~ok)[0]
                    rgb = rgb.copy()  # np.asarray of a device array is read-only
                    o_b = np.zeros((chunk, 3), np.float32)
                    d_b = np.tile(
                        np.array([[0, 0, 1]], np.float32), (chunk, 1)
                    )
                    o_b[: bad.size] = np.asarray(o_c)[bad]
                    d_b[: bad.size] = np.asarray(d_c)[bad]
                    dense = np.asarray(
                        render_chunk_fn(
                            params, occ_state,
                            jnp.asarray(o_b), jnp.asarray(d_b),
                        )
                    )
                    rgb[bad] = dense[: bad.size]
            outs.append(rgb)
        img = np.concatenate(outs)[:n].reshape(K.h, K.w, 3)
        rendered.append(img)
        save_png(img, folder / f"{name}_{i:04d}.png")
    return rendered


def evaluate(
    dataset: PoseSet, rendered: List[np.ndarray], indices: Sequence[int]
) -> List[EvalMetrics]:
    assert dataset.rgbs is not None
    return [
        eval_metrics(img, np.asarray(dataset[i]["rgbs"]))
        for i, img in zip(indices, rendered)
    ]


def render_only(
    cfg: TrainConfig,
    pose_set: PoseSet,
    mesh: Optional[Mesh] = None,
    name: str = "render",
) -> Optional[List[EvalMetrics]]:
    """Render `pose_set` from the latest checkpoint in cfg.output — the
    inference-only entry point (CLI `--render_only`).  Writes
    `{name}_{i:04d}.png` per pose and, when ground truth is present,
    `metrics_render.json`.  Returns the per-image metrics (None without
    ground truth)."""
    if mesh is None:
        mesh = make_mesh()
    output = Path(cfg.output)
    ck = latest_checkpoint(output)
    if ck is None:
        raise FileNotFoundError(f"no checkpoint found under {output}")
    step, state = load_checkpoint(ck)
    print(f"Rendering from {ck} (step {step})")

    renderer = build_renderer(
        cfg,
        scene_scale=pose_set.scene_scale,
        bg_color=(
            np.asarray(pose_set.bg_color)
            if pose_set.bg_color is not None
            else None
        ),
    )
    n_dev = mesh.devices.size
    render_chunk_fn = make_render_chunk(
        renderer, mesh if cfg.batch_size % n_dev == 0 else None
    )
    packed_fn = None
    grid_args: Tuple = ()
    if cfg.eval_render == "packed":
        can_skip = renderer.supports_skip_march
        eval_cap = cfg.batch_size * cfg.eval_samples_per_ray
        packed_fn = make_render_chunk_packed(
            renderer, eval_cap,
            mesh
            if (cfg.batch_size % n_dev == 0 and eval_cap % n_dev == 0)
            else None,
            march="skip" if can_skip else "dense",
        )
        if can_skip:
            grid_args = (jax.jit(renderer.skip_grid)(state["occ_state"]),)
    indices = list(range(len(pose_set)))
    rendered = infer(
        renderer, state["params"], state["occ_state"], pose_set, indices,
        output, name, chunk=cfg.batch_size, render_chunk_fn=render_chunk_fn,
        packed_fn=packed_fn, grid_args=grid_args,
    )
    if pose_set.rgbs is None:
        return None
    metrics = evaluate(pose_set, rendered, indices)
    with open(output / "metrics_render.json", "w") as f:
        json.dump([asdict(x) for x in metrics], f)
    psnrs = [m.psnr for m in metrics]
    print(f"rendered {len(metrics)} poses: psnr {np.mean(psnrs):.2f} "
          f"(min {np.min(psnrs):.2f}, max {np.max(psnrs):.2f})")
    return metrics


def pick_bucket(cfg: TrainConfig, avg_samples_per_ray: float) -> int:
    """Largest candidate-ray bucket whose expected sample demand fits the cap.

    This is the reference's dynamic-batching predictor (src/run.py:240's
    projected_size, i.e. the running samples/ray average) hoisted out of the
    graph: the host picks among precompiled static batch sizes instead of
    growing a dynamic one.
    """
    want = (
        cfg.sample_cap
        * cfg.bucket_overfill
        / max(avg_samples_per_ray, 1.0)
        / cfg.batch_size
    )
    bucket = min(cfg.ray_buckets)
    for b in sorted(cfg.ray_buckets):
        if b <= want:
            bucket = b
    if cfg.max_bucket is not None:
        bucket = min(bucket, cfg.max_bucket)
    return bucket


class BucketEstimator:
    """Running samples/ray estimate driving `pick_bucket`.

    The reference recomputes its demand predictor every iteration
    (projected_size, src/run.py:240).  Here each refresh costs one small
    device->host fetch, so refreshes are rate-limited to every
    `refresh_every` steps — EXCEPT right after an occupancy update, when
    demand jumps and a stale estimate would overflow (early training) or
    under-fill (late training) the sample buffer: `mark_occupancy_changed`
    forces the next observation to refresh.
    """

    def __init__(self, cfg: TrainConfig, refresh_every: int = 8):
        self.cfg = cfg
        self.refresh_every = refresh_every
        self.avg_samples_per_ray = float(cfg.n_samples)
        # True right after an observe() that actually fetched — callers can
        # piggyback their own (device-scalar) checks on the same cadence
        self.just_refreshed = False
        self._since = 0
        self._force = False

    def mark_occupancy_changed(self) -> None:
        self._force = True

    def observe(self, fill, rays_used) -> None:
        """Feed one step's (fill, rays_used) device scalars; fetches them
        only when a refresh is due."""
        self._since += 1
        if not (self._force or self._since >= self.refresh_every):
            self.just_refreshed = False
            return
        self.just_refreshed = True
        fill_v, rays_v = float(fill), float(rays_used)
        if rays_v > 0:
            self.avg_samples_per_ray = max(
                1.0, fill_v * self.cfg.sample_cap / rays_v
            )
        self._since = 0
        self._force = False

    def bucket(self) -> int:
        return pick_bucket(self.cfg, self.avg_samples_per_ray)


class MarchPolicy:
    """Dense-vs-skip marching choice, shared by train(), bench.py and
    tools/profile_step.py (one definition, so the bench provably measures
    the trainer's policy).

    The empty-space-skipping marcher engages once the demand estimate leaves
    ample scan-step budget (avg samples/ray <= SKIP_DEMAND_FRACTION *
    skip_steps).  Skip-marched rays that exhaust the budget anyway are
    loss-excluded, and systematically excluding the densest rays would bias
    training — so `observe` watches complete_frac on EVERY skip step (with a
    one-step lag: the check reads the PREVIOUS step's already-materialized
    device scalar, so it never stalls the dispatch pipeline) and, on a trip,
    falls back to dense marching FOR THE CURRENT OCCUPANCY EPOCH ONLY.  The
    next occupancy update re-probes, so a transient demand spike (e.g. right
    after an update, before the estimator refreshes) does not forfeit the
    skip marcher for the rest of the run.
    """

    SKIP_DEMAND_FRACTION = 0.35
    COMPLETE_MIN = 0.995

    def __init__(self, supported: bool, mode: str, skip_steps: int):
        assert mode in ("auto", "dense", "skip"), mode
        self.can_skip = supported and mode != "dense"
        self.forced = mode == "skip"
        self.skip_steps = skip_steps
        self.suspended = False  # until the next occupancy update
        self._pending = None  # complete_frac device scalar, last skip step

    def on_occupancy_update(self) -> None:
        self.suspended = False
        self._pending = None

    def pick(self, avg_samples_per_ray: float) -> str:
        if not self.can_skip or self.suspended:
            return "dense"
        if self.forced:
            return "skip"
        return (
            "skip"
            if avg_samples_per_ray
            <= self.SKIP_DEMAND_FRACTION * self.skip_steps
            else "dense"
        )

    def observe(self, complete_frac) -> Optional[float]:
        """Feed a skip step's complete_frac scalar; checks the previous
        one.  Returns the offending fraction when this trips the dense
        fallback, else None."""
        prev, self._pending = self._pending, complete_frac
        if prev is None:
            return None
        val = float(prev)
        if val < self.COMPLETE_MIN:
            self.suspended = True
            self._pending = None
            return val
        return None


# ---------------------------------------------------------------------- train


def _pad_pool(arr: np.ndarray, multiple: int) -> np.ndarray:
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, arr[:pad]])


def train(
    cfg: TrainConfig,
    train_rays: RayPool,
    eval_set: Optional[PoseSet] = None,
    test_set: Optional[PoseSet] = None,
    mesh: Optional[Mesh] = None,
    resume: bool = False,
) -> Dict[str, object]:
    """Full training run; returns {params, occ_state, metrics...}."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size

    output = Path(cfg.output)
    output.mkdir(parents=True, exist_ok=True)

    steps = cfg.total_steps
    renderer = build_renderer(
        cfg,
        scene_scale=train_rays.scene_scale,
        bg_color=np.asarray(train_rays.bg_color) if train_rays.bg_color is not None else None,
    )
    optimizer = make_optimizer(cfg)

    # ---- device-resident, mesh-sharded ray pool
    pool_o, pool_d, pool_rgb = (np.asarray(a) for a in train_rays.arrays())
    pool_o = _pad_pool(pool_o, n_dev)
    pool_d = _pad_pool(pool_d, n_dev)
    pool_rgb = _pad_pool(pool_rgb, n_dev)
    pool_o, pool_d, pool_rgb = shard_rays(mesh, pool_o, pool_d, pool_rgb)

    # ---- state init (or resume)
    key = jax.random.PRNGKey(cfg.seed if cfg.seed else 0)
    key, pkey = jax.random.split(key)
    params = renderer.init(pkey)
    opt_state = init_opt_state(renderer, optimizer, cfg, mesh, params)
    occ_state = renderer.occupancy.init_state()
    start_step = 0

    # sharded-table opt state is laid out per mesh size; validate before the
    # mismatch surfaces as an opaque tree/shape error inside optimizer.update
    ckpt_meta = {"shard_tables": bool(cfg.shard_tables), "n_devices": int(n_dev)}

    if resume:
        ck = latest_checkpoint(output)
        if ck is not None:
            start_step, state = load_checkpoint(ck)
            saved_meta = state.get("meta")
            if saved_meta is not None and (
                saved_meta.get("shard_tables") != ckpt_meta["shard_tables"]
                or (
                    saved_meta.get("shard_tables")
                    and saved_meta.get("n_devices") != ckpt_meta["n_devices"]
                )
            ):
                raise ValueError(
                    f"checkpoint {ck} was written with {saved_meta} but this "
                    f"run uses {ckpt_meta}; shard_tables checkpoints embed a "
                    "mesh-size-dependent optimizer layout — resume with the "
                    "same device count and --shard_tables setting"
                )
            params, opt_state, occ_state = (
                state["params"],
                state["opt_state"],
                state["occ_state"],
            )
            print(f"Resumed from {ck} at step {start_step}")

    n_params = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    print(f"Using {cfg.method} with {n_params} parameters on {n_dev} device(s).")

    # ---- per-(bucket, march-mode) compiled steps (lazy)
    steps_by_key: Dict[Tuple[int, str], object] = {}

    def get_step(bucket: int, march: str):
        k = (bucket, march)
        if k not in steps_by_key:
            steps_by_key[k] = make_train_step(
                renderer, optimizer, cfg, mesh,
                n_cand=bucket * cfg.batch_size, march=march,
            )
        return steps_by_key[k]

    policy = MarchPolicy(renderer.supports_skip_march, cfg.march, renderer.skip_steps)
    skip_fn = jax.jit(renderer.skip_grid) if policy.can_skip else None
    skip_grid = skip_fn(occ_state) if policy.can_skip else None

    occ_update = make_occupancy_update(
        renderer, mesh if cfg.occupancy_res % n_dev == 0 else None
    )
    render_chunk_fn = make_render_chunk(
        renderer, mesh if cfg.batch_size % n_dev == 0 else None
    )
    packed_chunk_fn = None
    if cfg.eval_render == "packed":
        eval_march = "skip" if policy.can_skip else "dense"
        eval_cap = cfg.batch_size * cfg.eval_samples_per_ray
        packed_chunk_fn = make_render_chunk_packed(
            renderer, eval_cap,
            mesh
            if (cfg.batch_size % n_dev == 0 and eval_cap % n_dev == 0)
            else None,
            march=eval_march,
        )

    def eval_grid_args():
        # the skip grid current at eval time (refreshed at occupancy updates)
        if packed_chunk_fn is not None and policy.can_skip:
            return (skip_grid,)
        return ()

    # ---- host loop
    train_metrics: List[TrainMetrics] = []
    eval_acc: List[EvalMetrics] = []
    # (step, wall-clock s, mean psnr, mean ssim) per eval round — the
    # timeline behind the time-to-X-PSNR metric
    eval_timeline: List[Dict[str, float]] = []
    pending: List[Tuple] = []  # (loss, occ, fill, rays) device scalars
    estimator = BucketEstimator(cfg)
    eval_ptr = 0
    t_start = time.perf_counter()
    rays_candidate = 0.0
    counters = {"rays_used": 0.0}

    def flush_pending():
        if not pending:
            return
        # one bulk host transfer (per-scalar fetches pay a round trip each)
        host_vals = jax.device_get(pending)
        for loss_v, occ_v, fill_v, rays_v in host_vals:
            train_metrics.append(
                TrainMetrics(loss=float(loss_v), occupancy=float(occ_v))
            )
            counters["rays_used"] += float(rays_v)
        pending.clear()

    # cached device scalar; recomputed only when the grid changes
    occ_frac = renderer.occupancy.occupancy(occ_state)

    profiling = False
    pbar = tqdm(range(start_step, steps))
    for step_i in pbar:
        # profiler hooks (SURVEY.md §5: the reference has no tracing at all)
        if cfg.profile_start is not None:
            if step_i == cfg.profile_start:
                jax.profiler.start_trace(str(output / "trace"))
                profiling = True
            elif profiling and step_i == cfg.profile_start + cfg.profile_count:
                jax.profiler.stop_trace()
                profiling = False

        # per-step keys derive from (base key, step index) so a resumed run
        # continues the stream instead of replaying it from the start
        kstep, kocc = jax.random.split(jax.random.fold_in(key, step_i))

        if step_i % cfg.occ_update_every == 0:
            occ_state = occ_update(params, occ_state, kocc)
            occ_frac = renderer.occupancy.occupancy(occ_state)
            if policy.can_skip:
                skip_grid = skip_fn(occ_state)
            estimator.mark_occupancy_changed()
            policy.on_occupancy_update()

        bucket = estimator.bucket()
        march = policy.pick(estimator.avg_samples_per_ray)
        step_fn = get_step(bucket, march)

        grid_args = (skip_grid,) if march == "skip" else ()
        params, opt_state, m = step_fn(
            params, opt_state, occ_state, *grid_args,
            pool_o, pool_d, pool_rgb, kstep,
        )
        pending.append((m["loss"], occ_frac, m["fill"], m["rays_used"]))
        rays_candidate += bucket * cfg.batch_size
        estimator.observe(m["fill"], m["rays_used"])
        if march == "skip":
            tripped = policy.observe(m["complete_frac"])
            if tripped is not None:
                print(
                    f"step {step_i}: {1 - tripped:.1%} of rays exhausted the "
                    f"skip-march step budget ({renderer.skip_steps}); dense "
                    f"marching until the next occupancy update"
                )

        if len(pending) >= 64 or step_i == steps - 1:
            flush_pending()
            if hasattr(pbar, "set_postfix") and train_metrics:
                pbar.set_postfix(
                    loss=train_metrics[-1].loss,
                    occupancy=train_metrics[-1].occupancy,
                    bucket=bucket,
                )

        if cfg.checkpoint_every and (step_i + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(
                output,
                step_i + 1,
                {"params": params, "opt_state": opt_state,
                 "occ_state": occ_state, "meta": ckpt_meta},
            )

        if (
            cfg.eval_every is not None
            and cfg.eval_n is not None
            and eval_set is not None
            and step_i > 0
            and step_i % cfg.eval_every == 0
        ):
            flush_pending()
            indices = [
                (eval_ptr + j) % len(eval_set) for j in range(cfg.eval_n)
            ]
            rendered = infer(
                renderer, params, occ_state, eval_set, indices, output,
                f"eval_{step_i}", chunk=cfg.batch_size,
                render_chunk_fn=render_chunk_fn,
                packed_fn=packed_chunk_fn, grid_args=eval_grid_args(),
            )
            round_metrics = evaluate(eval_set, rendered, indices)
            eval_acc.extend(round_metrics)
            if round_metrics:
                eval_timeline.append(
                    {
                        "step": step_i,
                        "elapsed_s": time.perf_counter() - t_start,
                        "psnr": float(np.mean([m.psnr for m in round_metrics])),
                        "ssim": float(np.mean([m.ssim for m in round_metrics])),
                    }
                )
            eval_ptr += cfg.eval_n

    if profiling:
        jax.profiler.stop_trace()
    flush_pending()
    elapsed = time.perf_counter() - t_start
    # headline metric counts only rays that contributed to the loss (same
    # definition as bench.py); candidate throughput (incl. overfill-dropped
    # and incomplete rays) is reported separately
    rays_per_sec_per_chip = counters["rays_used"] / max(elapsed, 1e-9) / n_dev
    cand_rays_per_sec_per_chip = rays_candidate / max(elapsed, 1e-9) / n_dev

    # ---- final test render + artifacts
    test_metrics: Optional[List[EvalMetrics]] = None
    if test_set is not None:
        indices = list(range(len(test_set)))
        rendered = infer(
            renderer, params, occ_state, test_set, indices, output, "test_full",
            chunk=cfg.batch_size, render_chunk_fn=render_chunk_fn,
            packed_fn=packed_chunk_fn, grid_args=eval_grid_args(),
        )
        if test_set.rgbs is not None:
            test_metrics = evaluate(test_set, rendered, indices)

    save_checkpoint(
        output, steps,
        {"params": params, "opt_state": opt_state, "occ_state": occ_state,
         "meta": ckpt_meta},
    )

    with open(output / "metrics_train.json", "w") as f:
        json.dump([asdict(x) for x in train_metrics], f)
    if eval_acc:
        with open(output / "metrics_eval.json", "w") as f:
            json.dump([asdict(x) for x in eval_acc], f)
    if eval_timeline:
        with open(output / "eval_timeline.json", "w") as f:
            json.dump(eval_timeline, f)
    if test_metrics:
        with open(output / "metrics_test.json", "w") as f:
            json.dump([asdict(x) for x in test_metrics], f)
    with open(output / "throughput.json", "w") as f:
        json.dump(
            {
                "rays_per_sec_per_chip": rays_per_sec_per_chip,
                "candidate_rays_per_sec_per_chip": cand_rays_per_sec_per_chip,
                "elapsed_s": elapsed,
                "steps": steps - start_step,
                "n_devices": n_dev,
            },
            f,
        )

    return {
        "params": params,
        "occ_state": occ_state,
        "renderer": renderer,
        "train_metrics": train_metrics,
        "eval_metrics": eval_acc,
        "eval_timeline": eval_timeline,
        "test_metrics": test_metrics,
        "rays_per_sec_per_chip": rays_per_sec_per_chip,
    }
