"""Unit tests for host-side training-loop policy pieces."""

from pathlib import Path

from tinynerf.train import TrainConfig
from tinynerf.train.loop import BucketEstimator, lr_schedule, pick_bucket


def cfg(**kw):
    base = dict(method="kplanes", output=Path("/tmp/x"), batch_size=2048, n_samples=400)
    base.update(kw)
    return TrainConfig(**base)


def test_pick_bucket_all_occupied():
    # everything survives: demand per candidate ray = n_samples -> bucket 1
    assert pick_bucket(cfg(), avg_samples_per_ray=400.0) == 1


def test_pick_bucket_converged():
    # ~25 samples/ray -> 16x more candidate rays fit the cap
    assert pick_bucket(cfg(), avg_samples_per_ray=25.0) == 16


def test_pick_bucket_intermediate():
    # 80 samples/ray -> want = 400/80 = 5 -> bucket 4
    assert pick_bucket(cfg(), avg_samples_per_ray=80.0) == 4


def test_pick_bucket_degenerate():
    c = cfg()
    assert pick_bucket(c, avg_samples_per_ray=0.0) == max(c.ray_buckets)
    assert pick_bucket(c, avg_samples_per_ray=1e9) == 1


def test_pick_bucket_overfill():
    # demand 41 samples/ray -> exact fit would be 400/41 = 9.76; with the
    # default 1.15 overfill the policy may exceed the cap slightly -> 11.2 ->
    # bucket 8; disabling overfill keeps it at 8 too, but at 36 samples/ray
    # overfill reaches 12 while exact-fit stays at 8
    c = cfg()
    assert pick_bucket(c, avg_samples_per_ray=36.0) == 12
    c0 = cfg(bucket_overfill=1.0)
    assert pick_bucket(c0, avg_samples_per_ray=36.0) == 8


def test_estimator_refreshes_after_occupancy_change():
    """The bucket must adapt on the FIRST observation after an occupancy
    update, not after the periodic refresh window."""
    c = cfg()
    est = BucketEstimator(c, refresh_every=64)
    # steady state: everything occupied -> 400 samples/ray -> bucket 1
    est.observe(fill=1.0, rays_used=2048.0)  # forced? no: _since=1 < 64
    assert est.bucket() == 1  # initial estimate = n_samples
    # occupancy collapse: demand drops to ~25 samples/ray
    est.mark_occupancy_changed()
    est.observe(fill=25.0 * 2048 / c.sample_cap, rays_used=2048.0)
    assert est.avg_samples_per_ray == 25.0
    assert est.bucket() >= 16  # adapted immediately


def test_estimator_periodic_refresh():
    c = cfg()
    est = BucketEstimator(c, refresh_every=3)
    for _ in range(2):
        est.observe(fill=0.1, rays_used=2048.0)
    assert est.avg_samples_per_ray == float(c.n_samples)  # not yet
    est.observe(fill=0.1, rays_used=2048.0)  # 3rd -> refresh
    assert est.avg_samples_per_ray == 0.1 * c.sample_cap / 2048.0


def test_lr_milestones_compose_on_collision():
    """At steps=8 the 0.75 and 5/6 milestones both land on step 6: torch
    MultiStepLR applies gamma per occurrence, so the schedule must decay
    twice there (4 decays total at any step count)."""
    c = cfg(steps=8, lr_init=1.0, lr_gamma=0.33)
    sched = lr_schedule(c)
    # milestones: 0.5*8=4, 0.75*8=6, (5/6)*8=6, 0.9*8=7
    assert abs(float(sched(3)) - 1.0) < 1e-6
    assert abs(float(sched(4)) - 0.33) < 1e-6
    assert abs(float(sched(6)) - 0.33**3) < 1e-6  # composed double decay
    assert abs(float(sched(7)) - 0.33**4) < 1e-6


def test_schedule_derivations():
    c = cfg(batch_size=2048)
    assert c.total_steps == 4096  # 2048 * (4096/2048)
    assert c.occ_update_every == 32
    assert abs(c.occ_decay - 0.01 ** (1 / 16)) < 1e-12
    assert c.sample_cap == 2048 * 400

    c2 = cfg(batch_size=4096)
    assert c2.total_steps == 2048
    assert c2.occ_update_every == 16


def test_split_table_lr():
    """lr_tables scales updates of non-MLP params by lr_tables/lr while MLP
    params follow the base lr."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tinynerf.train.loop import make_optimizer

    c = cfg(lr_init=1e-3, lr_tables=1e-2, weight_decay=0.0)
    opt = make_optimizer(c)
    params = {
        "field": {"planes": [[jnp.ones((4, 4, 2))]]},
        "rgb": {"mlp": [(jnp.ones((3, 3)), jnp.zeros(3))]},
    }
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    state = opt.init(params)
    updates, _ = opt.update(grads, state, params)
    # Adam normalizes unit grads to ~1 -> update magnitude == group lr
    table_up = float(jnp.abs(updates["field"]["planes"][0][0]).mean())
    mlp_up = float(jnp.abs(updates["rgb"]["mlp"][0][0]).mean())
    np.testing.assert_allclose(table_up / mlp_up, 10.0, rtol=1e-4)
    np.testing.assert_allclose(mlp_up, 1e-3, rtol=1e-3)


def test_decay_tables_switch():
    """decay_tables=True (reference semantics) applies weight decay to raw
    feature tables; default masks them out."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tinynerf.train.loop import make_optimizer

    params = {"field": {"planes": [[jnp.full((4, 4, 2), 2.0)]]},
              "rgb": {"mlp": [(jnp.full((3, 3), 2.0), jnp.zeros(3))]}}
    zero_grads = jax.tree_util.tree_map(jnp.zeros_like, params)

    outs = {}
    for dt in (False, True):
        c = cfg(lr_init=1e-3, weight_decay=1e-2, decay_tables=dt)
        opt = make_optimizer(c)
        updates, _ = opt.update(zero_grads, opt.init(params), params)
        outs[dt] = float(jnp.abs(updates["field"]["planes"][0][0]).max())
    assert outs[False] == 0.0          # tables masked out of decay
    assert outs[True] > 0.0            # reference decays everything


def test_fused_adam_matches_optax_chain():
    """The fused single-pass optimizer (train/loop._fused_adam) must
    reproduce the optax chain it replaces — add_decayed_weights +
    scale_by_adam + scale_by_learning_rate + masked table scale — exactly
    (same op order, same f32 math) over several steps."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from functools import partial

    from tinynerf.train.loop import (
        _decay_mask,
        lr_schedule,
        make_optimizer,
    )

    c = cfg(method="cobafa", lr_init=1e-3, lr_tables=1e-2, weight_decay=1e-5)
    # reference chain, built exactly as rounds 1-4 did
    schedule = lr_schedule(c)
    from tinynerf.models.registry import make_model

    field, _, _ = make_model(c.method)
    mask_fn = partial(
        _decay_mask,
        table_keys=frozenset(field.table_keys),
        mlp_keys=frozenset(field.mlp_keys),
    )
    ratio = c.effective_lr_tables / c.effective_lr

    def table_mask(params):
        return jax.tree_util.tree_map(lambda m: not m, mask_fn(params))

    chain = optax.chain(
        optax.add_decayed_weights(c.weight_decay, mask=mask_fn),
        optax.scale_by_adam(eps=c.adam_eps),
        optax.scale_by_learning_rate(schedule),
        optax.masked(optax.scale(ratio), table_mask),
    )
    fused = make_optimizer(c)

    key = jax.random.PRNGKey(0)
    params = {
        "field": {"basis": [jax.random.normal(key, (5, 5, 2))],
                  "mlp": [(jax.random.normal(jax.random.PRNGKey(1), (4, 4)),
                           jnp.zeros(4))]},
        "rgb": {"mlp": [(jax.random.normal(jax.random.PRNGKey(2), (3, 3)),
                         jnp.zeros(3))]},
    }
    # cobafa declares table_keys={'basis','coef'}; our toy tree uses 'basis'
    sc, sf = chain.init(params), fused.init(params)
    pc = pf = params
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda p: jax.random.normal(jax.random.PRNGKey(10 + i), p.shape),
            params,
        )
        uc, sc = chain.update(g, sc, pc)
        uf, sf = fused.update(g, sf, pf)
        for a, b in zip(jax.tree_util.tree_leaves(uc),
                        jax.tree_util.tree_leaves(uf)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        pc = optax.apply_updates(pc, uc)
        pf = optax.apply_updates(pf, uf)


def test_method_aware_lr_defaults():
    """Per-method lr defaults (spheres-scene sweeps): K-Planes keeps the
    reference's 1e-2; vanilla/cobafa use the swept optima."""
    assert cfg(method="kplanes").effective_lr == 1e-2
    assert cfg(method="vanilla").effective_lr == 1e-3
    assert cfg(method="cobafa").effective_lr == 3e-3
    assert cfg(method="cobafa", lr_init=5e-4).effective_lr == 5e-4


def test_march_policy_demand_threshold():
    from tinynerf.train.loop import MarchPolicy

    p = MarchPolicy(supported=True, mode="auto", skip_steps=64)
    assert p.pick(10.0) == "skip"       # ample budget
    assert p.pick(30.0) == "dense"      # 30 > 0.35 * 64
    assert MarchPolicy(False, "auto", 64).pick(1.0) == "dense"
    assert MarchPolicy(True, "dense", 64).pick(1.0) == "dense"
    assert MarchPolicy(True, "skip", 64).pick(1e9) == "skip"


def test_march_policy_transient_fallback_recovers():
    """A budget-exhaustion trip falls back to dense ONLY until the next
    occupancy update — a transient demand spike must not forfeit the skip
    marcher for the rest of the run (the round-2 one-way latch)."""
    from tinynerf.train.loop import MarchPolicy

    p = MarchPolicy(supported=True, mode="auto", skip_steps=64)
    assert p.pick(5.0) == "skip"
    assert p.observe(0.90) is None       # one-step lag: first obs pends
    tripped = p.observe(1.0)             # checks the previous (0.90)
    assert tripped == 0.90
    assert p.pick(5.0) == "dense"        # suspended for this epoch
    p.on_occupancy_update()              # re-probe at the next update
    assert p.pick(5.0) == "skip"
    # healthy stream never trips
    for v in (1.0, 0.999, 1.0):
        assert p.observe(v) is None
    assert p.pick(5.0) == "skip"


def test_decay_mask_derived_from_field_declarations():
    """The decay/split-lr group masks come from the field module's declared
    table_keys/mlp_keys; undeclared field params must fail loudly instead of
    silently decaying."""
    import jax.numpy as jnp
    import pytest

    from tinynerf.models import make_model
    from tinynerf.train.loop import _decay_mask

    for method, table_key in (("kplanes", "planes"), ("cobafa", "basis")):
        # smallest valid scale: the mask derivation only reads pytree keys,
        # but init() is kept so declared table_keys/mlp_keys are checked
        # against the REAL param structure
        field, _, _ = make_model(method, field_scale=0.125)
        params = {
            "field": field.init(__import__("jax").random.PRNGKey(0)),
            "sigma": {"mlp": [(jnp.ones((2, 2)), jnp.zeros(2))]},
        }
        mask = _decay_mask(
            params, table_keys=field.table_keys, mlp_keys=field.mlp_keys
        )
        table_leaves = __import__("jax").tree_util.tree_leaves(
            mask["field"][table_key]
        )
        assert table_leaves and not any(table_leaves)  # tables never decay
        assert all(__import__("jax").tree_util.tree_leaves(mask["sigma"]))

    field, _, _ = make_model("kplanes")
    bad = {"field": {"planes": [], "surprise": jnp.ones(3)}, "sigma": {}}
    with pytest.raises(ValueError, match="surprise"):
        _decay_mask(bad, table_keys=field.table_keys, mlp_keys=field.mlp_keys)


def test_pick_bucket_max_bucket_cap():
    # the sparse-view overfit knob clamps the ladder (an uncapped converged
    # ladder = 24x effective batch on a
    # 12-view scene); None leaves it unlimited
    assert pick_bucket(cfg(max_bucket=4), avg_samples_per_ray=25.0) == 4
    assert pick_bucket(cfg(max_bucket=None), avg_samples_per_ray=25.0) == 16
    # cap above the picked bucket is a no-op
    assert pick_bucket(cfg(max_bucket=64), avg_samples_per_ray=25.0) == 16
