"""Sharded-table (ZeRO-1) training tests — parallel/zero.py + the
shard_tables step variant in train/loop.py.

The reference has no distributed counterpart (SURVEY.md §5); the contract
under test is internal consistency: the sharded-optimizer step must produce
the same numbers as the replicated data-parallel step on the identical
global batch, and the row-partitioned regularizer partials must sum to the
full regularizer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynerf.models.kplanes import KPlanesFeatureField
from tinynerf.parallel import make_mesh
from tinynerf.parallel.zero import (
    global_view,
    spec_tree,
    table_mask_tree,
)

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("n_blocks", [1, 3, 8])
def test_tv_l1_partials_sum_to_full(n_blocks):
    """sum_k loss_*_partial(params, k, n) == loss_*(params) for block counts
    that do and don't divide the (odd) plane rows."""
    field = KPlanesFeatureField(
        feature_dim_per_plane=4, resolutions=(9, 17), init_range=(0.0, 1.0)
    )
    params = field.init(KEY)
    for full_fn, part_fn in (
        (field.loss_tv, field.loss_tv_partial),
        (field.loss_l1, field.loss_l1_partial),
    ):
        full = float(full_fn(params))
        total = sum(
            float(part_fn(params, jnp.int32(k), n_blocks))
            for k in range(n_blocks)
        )
        np.testing.assert_allclose(total, full, rtol=1e-5)


def test_tv_partial_grads_sum_to_full():
    field = KPlanesFeatureField(
        feature_dim_per_plane=4, resolutions=(9, 17), init_range=(0.0, 1.0)
    )
    params = field.init(KEY)
    n = 8
    g_full = jax.grad(field.loss_tv)(params)
    # ONE jitted grad with k as a traced arg (exactly how the ZeRO step
    # calls it, k = axis_index) — 8 eager grad traversals cost ~10 s here
    g_fn = jax.jit(jax.grad(lambda p, k: field.loss_tv_partial(p, k, n)))
    g_sum = None
    for k in range(n):
        g_k = g_fn(params, jnp.int32(k))
        g_sum = g_k if g_sum is None else jax.tree_util.tree_map(
            jnp.add, g_sum, g_k
        )
    for a, b in zip(
        jax.tree_util.tree_leaves(g_full), jax.tree_util.tree_leaves(g_sum)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-8
        )


def test_view_spec_trees_classify_by_declared_keys():
    """Table classification must follow the field's declaration through the
    param tree AND an optax-like wrapper tree (mu/nu mirror params)."""
    params = {
        "field": {"planes": [[jnp.zeros((5, 5, 2))]], "extra_mlp": jnp.zeros(3)},
        "sigma": {"linear": {"w": jnp.zeros((4, 4))}},
    }
    tk = frozenset({"planes"})
    mask = table_mask_tree(params, tk)
    assert mask["field"]["planes"][0][0] is True
    assert mask["field"]["extra_mlp"] is False
    assert mask["sigma"]["linear"]["w"] is False

    # optax-style wrapper: params embedded under a state prefix
    wrapped = {"mu": params, "count": jnp.zeros(())}
    specs = spec_tree(wrapped, tk)
    assert specs["mu"]["field"]["planes"][0][0] == jax.sharding.PartitionSpec("data")
    assert specs["count"] == jax.sharding.PartitionSpec()

    # global view flattens + pads ONLY table leaves, preserving structure
    view = global_view(params, tk, n_shards=8)
    v = view["field"]["planes"][0][0]
    assert v.ndim == 1 and v.shape[0] % 8 == 0 and v.shape[0] >= 50
    assert view["sigma"]["linear"]["w"].shape == (4, 4)


@pytest.mark.slow
def test_zero_checkpoint_resume_continues_identically(synthetic_scene, tmp_path):
    """The sharded optimizer state must survive the pickle checkpoint
    round-trip (train/checkpoint.py): 2 steps + save + load + 2 steps must
    reproduce 4 uninterrupted steps bit-for-bit on the same mesh — the
    contract behind TrainConfig.shard_tables' resume note."""
    from tinynerf.data import RayPool, parse_nerf_synthetic
    from tinynerf.train import TrainConfig, build_renderer, make_optimizer
    from tinynerf.train.checkpoint import load_checkpoint, save_checkpoint
    from tinynerf.train.loop import init_opt_state, make_train_step

    train_rays = RayPool(parse_nerf_synthetic(synthetic_scene, "train"))
    cfg = TrainConfig(
        method="kplanes",
        scene_type="aabb",
        output=tmp_path / "exp",
        batch_size=64,
        n_samples=16,
        steps=4,
        occupancy_res=16,
        compute_dtype="float32",
        tv_reg_alpha=1e-4,
        shard_tables=True,
    )
    n_cand = 64
    o, d, rgb = (np.asarray(a)[:n_cand] for a in train_rays.arrays())
    renderer = build_renderer(cfg, train_rays.scene_scale, train_rays.bg_color)
    optimizer = make_optimizer(cfg)
    mesh = make_mesh(jax.devices()[:8])

    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data"))
    pools_dev = tuple(jax.device_put(a, sh) for a in (o, d, rgb))
    step_fn = make_train_step(renderer, optimizer, cfg, mesh, n_cand=n_cand)
    occ0 = renderer.occupancy.init_state()
    keys = [jax.random.PRNGKey(100 + i) for i in range(4)]

    def fresh():
        p = renderer.init(jax.random.PRNGKey(3))
        return p, init_opt_state(renderer, optimizer, cfg, mesh, p)

    # uninterrupted 4 steps
    params, opt_state = fresh()
    for k in keys:
        params, opt_state, _ = step_fn(params, opt_state, occ0, *pools_dev, k)
    p_ref = jax.device_get(params)

    # 2 steps -> checkpoint -> load -> 2 steps
    params, opt_state = fresh()
    for k in keys[:2]:
        params, opt_state, _ = step_fn(params, opt_state, occ0, *pools_dev, k)
    save_checkpoint(tmp_path / "ck", 2, {"params": params, "opt": opt_state})
    _, state = load_checkpoint(tmp_path / "ck" / "ckpt_2.pkl")
    params, opt_state = state["params"], state["opt"]
    for k in keys[2:]:
        params, opt_state, _ = step_fn(params, opt_state, occ0, *pools_dev, k)

    for a, b in zip(
        jax.tree_util.tree_leaves(p_ref),
        jax.tree_util.tree_leaves(jax.device_get(params)),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_zero_step_matches_replicated(synthetic_scene, tmp_path):
    """One shard_tables=True step on the 8-device mesh must produce the same
    loss, grads, and updated params as the replicated 8-device step on the
    identical deterministic batch — the end-to-end guard on the
    scatter/shard/gather plumbing AND the partitioned regularizer."""
    from tinynerf.data import RayPool, parse_nerf_synthetic
    from tinynerf.train import TrainConfig, build_renderer, make_optimizer
    from tinynerf.train.loop import init_opt_state, make_train_step

    train_rays = RayPool(parse_nerf_synthetic(synthetic_scene, "train"))
    cfg = TrainConfig(
        method="kplanes",
        scene_type="aabb",
        output=tmp_path / "exp",
        batch_size=64,
        n_samples=16,
        steps=3,
        occupancy_res=16,
        compute_dtype="float32",
        tv_reg_alpha=1e-4,
        l1_reg_alpha=1e-5,
    )
    n_cand = 64
    o, d, rgb = (np.asarray(a)[:n_cand] for a in train_rays.arrays())
    renderer = build_renderer(cfg, train_rays.scene_scale, train_rays.bg_color)
    # shrink the field: the plumbing under test (flat views, psum_scatter,
    # partial TV, banded pullback) is size-agnostic, and the full 513^2
    # tables cost minutes of CPU-mesh compile per step variant
    from tinynerf.models.vanilla import ColorDecoder, OpacityDecoder

    small = KPlanesFeatureField(feature_dim_per_plane=8, resolutions=(9, 17, 33))
    renderer = dataclasses.replace(
        renderer,
        field=small,
        sigma_decoder=OpacityDecoder(feature_dim=small.feature_dim),
        rgb_decoder=ColorDecoder(
            n_freqs=8, in_features=small.feature_dim, hidden_features=16,
            hidden_layers=2,
        ),
    )
    optimizer = make_optimizer(cfg)
    params0 = renderer.init(jax.random.PRNGKey(3))
    occ0 = renderer.occupancy.init_state()
    key = jax.random.PRNGKey(7)
    mesh = make_mesh(jax.devices()[:8])

    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data"))
    pools_dev = tuple(jax.device_put(a, sh) for a in (o, d, rgb))

    results = {}
    for name, shard, sbwd in (
        ("replicated", False, False),
        ("zero", True, False),
        # shard_bwd: the fused backward's fine-grad pullback runs row-banded
        # per device (ops/interp.py _sharded_pullback); per-device grads are
        # PARTIALS that the step's reductions must sum to the same numbers
        ("zero_bwd", True, True),
    ):
        c = dataclasses.replace(cfg, shard_tables=shard, shard_bwd=sbwd)
        step_fn = make_train_step(
            renderer, optimizer, c, mesh, n_cand=n_cand, deterministic=True
        )
        params = jax.tree_util.tree_map(jnp.array, params0)
        opt_state = init_opt_state(renderer, optimizer, c, mesh, params)
        p1, os1, m = step_fn(params, opt_state, occ0, *pools_dev, key)
        results[name] = (p1, os1, m)

    m_rep = results["replicated"][2]
    for variant in ("zero", "zero_bwd"):
        m_zero = results[variant][2]
        np.testing.assert_allclose(
            float(m_zero["loss"]), float(m_rep["loss"]), rtol=1e-5
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(m_rep["grads"]),
            jax.tree_util.tree_leaves(m_zero["grads"]),
        ):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-6
            )
        # updated params: tables went through shard->Adam->all_gather; must
        # land where the replicated update landed
        for a, b in zip(
            jax.tree_util.tree_leaves(results["replicated"][0]),
            jax.tree_util.tree_leaves(results[variant][0]),
        ):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-6
            )
    # the sharded opt state actually IS sharded: table moment leaves are
    # flat padded vectors, not plane-shaped
    zmask = table_mask_tree(results["zero"][1], frozenset({"planes"}))
    flat_leaves = [
        leaf
        for leaf, is_t in zip(
            jax.tree_util.tree_leaves(results["zero"][1]),
            jax.tree_util.tree_leaves(zmask),
        )
        if is_t
    ]
    assert flat_leaves, "no sharded table moments found in opt state"
    assert all(l.ndim == 1 and l.shape[0] % 8 == 0 for l in flat_leaves)
