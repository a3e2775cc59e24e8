"""End-to-end training tests on the generated fixture — the integration
coverage the reference lacks (its suite never calls train(); SURVEY.md §4).
Runs tiny configs on the CPU backend with an 8-device virtual mesh."""

import json

import jax
import numpy as np
import pytest

from tinynerf.data import PoseSet, RayPool, parse_nerf_synthetic
from tinynerf.parallel import make_mesh
from tinynerf.train import (
    TrainConfig,
    latest_checkpoint,
    load_checkpoint,
    train,
)


def tiny_cfg(tmp_path, **kw):
    defaults = dict(
        method="kplanes",
        scene_type="aabb",
        output=tmp_path / "exp",
        batch_size=64,
        n_samples=16,
        steps=3,
        occupancy_res=16,
        occupancy_update_every=2,
        ray_buckets=(1, 2),
        seed=1,
        # quarter-capacity fields (structurally identical: same scale count,
        # nesting, feature dims — models/registry.py) keep these end-to-end
        # tests about the LOOP, not about compiling 33M-param tables on CPU
        field_scale=0.25,
    )
    defaults.update(kw)
    return TrainConfig(**defaults)


@pytest.fixture(scope="module")
def pools(synthetic_scene):
    train_rays = RayPool(parse_nerf_synthetic(synthetic_scene, "train"))
    test_set = PoseSet(parse_nerf_synthetic(synthetic_scene, "test"))
    return train_rays, test_set


@pytest.mark.slow
def test_train_end_to_end_single_device(pools, tmp_path):
    train_rays, test_set = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(tmp_path)
    out = train(cfg, train_rays, eval_set=None, test_set=test_set, mesh=mesh)

    assert len(out["train_metrics"]) == 3
    assert all(np.isfinite(m.loss) for m in out["train_metrics"])
    assert out["test_metrics"] is not None and len(out["test_metrics"]) == 2
    for em in out["test_metrics"]:
        assert np.isfinite(em.psnr)
        assert -1.0 <= em.ssim <= 1.0

    # artifacts: metrics json, rendered PNGs, checkpoint
    exp = cfg.output
    assert (exp / "metrics_train.json").exists()
    assert (exp / "metrics_test.json").exists()
    assert (exp / "test_full_0000.png").exists()
    assert latest_checkpoint(exp) is not None
    with open(exp / "metrics_train.json") as f:
        recs = json.load(f)
    assert len(recs) == 3 and "loss" in recs[0] and "occupancy" in recs[0]


def test_train_multichip_mesh(pools, tmp_path):
    """Full train step sharded over 8 virtual devices (psum'd grads)."""
    train_rays, test_set = pools
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(jax.devices()[:8])
    cfg = tiny_cfg(tmp_path, method="vanilla", steps=2)
    # test_set included: the final render exercises the packed eval path
    # (and its wiring) under the mesh
    out = train(cfg, train_rays, eval_set=None, test_set=test_set, mesh=mesh)
    assert len(out["train_metrics"]) == 2
    assert all(np.isfinite(m.loss) for m in out["train_metrics"])
    assert out["test_metrics"] is not None
    assert all(np.isfinite(em.psnr) for em in out["test_metrics"])


def test_sharded_matches_single_device_grads(pools, tmp_path):
    """The psum'd 8-device train step must produce the SAME loss and grads
    as the 1-device step on the identical global batch.

    Uses make_train_step's deterministic seam: each device consumes its
    leading pool-shard rays (no rng gather) and jitter is disabled, so with
    a pool of exactly n_cand rays the 8-way shards partition the same batch
    the single device sees.  This guards the psum/scale math of the sharded
    step (loss numerator/denominator and gradient reduction)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tinynerf.train import build_renderer, make_optimizer
    from tinynerf.train.loop import make_train_step

    train_rays, _ = pools
    # f32 compute: bf16 matmul reductions split differently across mesh
    # sizes; this test guards the psum/scale math, not dtype noise
    cfg = tiny_cfg(
        tmp_path, method="vanilla", batch_size=64, n_samples=16,
        compute_dtype="float32",
    )
    n_cand = 64

    o, d, rgb = (np.asarray(a)[:n_cand] for a in train_rays.arrays())
    renderer = build_renderer(cfg, train_rays.scene_scale, train_rays.bg_color)
    optimizer = make_optimizer(cfg)
    params0 = renderer.init(jax.random.PRNGKey(3))
    occ0 = renderer.occupancy.init_state()
    key = jax.random.PRNGKey(7)

    results = {}
    for name, devs in (("single", 1), ("multi", 8)):
        mesh = make_mesh(jax.devices()[:devs])
        sh = NamedSharding(mesh, P("data"))
        pools_dev = tuple(jax.device_put(a, sh) for a in (o, d, rgb))
        step_fn = make_train_step(
            renderer, optimizer, cfg, mesh, n_cand=n_cand, deterministic=True
        )
        params = jax.tree_util.tree_map(jnp.array, params0)  # fresh (donated)
        opt_state = optimizer.init(params)
        _, _, m = step_fn(params, opt_state, occ0, *pools_dev, key)
        results[name] = m

    assert np.allclose(
        float(results["single"]["loss"]), float(results["multi"]["loss"]),
        rtol=1e-5, atol=1e-7,
    )
    g1 = jax.tree_util.tree_leaves(results["single"]["grads"])
    g8 = jax.tree_util.tree_leaves(results["multi"]["grads"])
    assert len(g1) == len(g8) and len(g1) > 0
    for a, b in zip(g1, g8):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
        )


def test_checkpoint_resume(pools, tmp_path):
    train_rays, _ = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(tmp_path, method="vanilla", steps=2, checkpoint_every=1)
    train(cfg, train_rays, mesh=mesh)
    ck = latest_checkpoint(cfg.output)
    assert ck is not None
    step, state = load_checkpoint(ck)
    assert step == 2
    assert "params" in state and "opt_state" in state and "occ_state" in state

    # resume continues from the saved step
    cfg2 = tiny_cfg(tmp_path, method="vanilla", steps=4, checkpoint_every=0)
    out = train(cfg2, train_rays, mesh=mesh, resume=True)
    assert len(out["train_metrics"]) == 2  # steps 2..4


@pytest.mark.parametrize("suffix", ["old", "v0"])
def test_checkpoint_under_former_package_name_loads(tmp_path, monkeypatch, suffix):
    """A checkpoint whose classes were pickled under the package's former
    name (`tinynerf_<suffix>`) loads into the present package's classes."""
    import sys
    import types

    from tinynerf.core.occupancy import OccupancyState
    from tinynerf.train import save_checkpoint

    former = f"tinynerf_{suffix}.core.occupancy"
    parts = former.split(".")
    for i in range(1, len(parts) + 1):
        monkeypatch.setitem(sys.modules, ".".join(parts[:i]), types.ModuleType(".".join(parts[:i])))
    monkeypatch.setattr(sys.modules[former], "OccupancyState", OccupancyState, raising=False)
    monkeypatch.setattr(OccupancyState, "__module__", former)
    occ = OccupancyState(np.ones((2, 2, 2), np.float32), np.float32(1.0))
    path = save_checkpoint(tmp_path, 7, {"occ_state": occ})
    monkeypatch.undo()
    assert former.encode() in path.read_bytes()

    step, state = load_checkpoint(path)
    assert step == 7
    assert type(state["occ_state"]) is OccupancyState
    np.testing.assert_array_equal(state["occ_state"].grid, occ.grid)


def test_render_only(pools, tmp_path):
    """render_only() renders the test split from the latest checkpoint and
    writes per-image metrics (the CLI --render_only surface)."""
    from tinynerf.train.loop import render_only

    train_rays, test_set = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(tmp_path, method="vanilla", steps=2, checkpoint_every=2)
    train(cfg, train_rays, mesh=mesh)
    metrics = render_only(cfg, test_set, mesh=mesh)
    assert metrics is not None and len(metrics) == len(test_set)
    assert all(np.isfinite(m.psnr) for m in metrics)
    assert (cfg.output / "metrics_render.json").exists()
    assert (cfg.output / "render_0000.png").exists()


def test_infer_packed_matches_dense(pools, tmp_path):
    """The packed serving path (and its overflow fallback, and the
    skip-marched variant) must produce the same images as the dense
    reference eval — packed eval is an optimization, not an approximation."""
    from tinynerf.train import build_renderer
    from tinynerf.train.loop import (
        infer,
        make_render_chunk,
        make_render_chunk_packed,
    )

    train_rays, test_set = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(tmp_path, method="vanilla", steps=2)
    train(cfg, train_rays, mesh=mesh)
    _, state = load_checkpoint(latest_checkpoint(cfg.output))
    params, occ_state = state["params"], state["occ_state"]

    renderer = build_renderer(
        cfg, scene_scale=test_set.scene_scale,
        bg_color=np.asarray(test_set.bg_color)
        if test_set.bg_color is not None else None,
    )
    dense_fn = make_render_chunk(renderer)

    def run(sub, **kw):
        return infer(
            renderer, params, occ_state, test_set, [0], tmp_path / sub, sub,
            chunk=cfg.batch_size, render_chunk_fn=dense_fn, **kw,
        )[0]

    ref = run("dense")

    cap = cfg.batch_size * cfg.n_samples  # ample: nothing overflows
    packed = make_render_chunk_packed(renderer, cap, march="dense")
    np.testing.assert_allclose(run("packed", packed_fn=packed), ref,
                               atol=1e-5, rtol=0)

    # a starved cap forces the dense fallback for (almost) every ray
    tiny = make_render_chunk_packed(renderer, 8, march="dense")
    np.testing.assert_allclose(run("fallback", packed_fn=tiny), ref,
                               atol=1e-5, rtol=0)

    assert renderer.supports_skip_march
    grid = jax.jit(renderer.skip_grid)(occ_state)
    skip = make_render_chunk_packed(renderer, cap, march="skip")
    np.testing.assert_allclose(
        run("skip", packed_fn=skip, grid_args=(grid,)), ref,
        atol=1e-5, rtol=0,
    )

    # sharded packed chunk: same images as single-device (per-shard caps
    # change which rays overflow, never what valid rays render)
    mesh8 = make_mesh(jax.devices())
    sharded = make_render_chunk_packed(renderer, cap, mesh=mesh8,
                                       march="dense")
    np.testing.assert_allclose(run("sharded", packed_fn=sharded), ref,
                               atol=1e-5, rtol=0)


def test_unbounded_training(pools, tmp_path):
    train_rays, _ = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(tmp_path, method="vanilla", scene_type="unbounded", steps=2)
    out = train(cfg, train_rays, mesh=mesh)
    assert all(np.isfinite(m.loss) for m in out["train_metrics"])


@pytest.mark.slow
def test_train_forced_skip_march(pools, tmp_path):
    """train() with march='skip' forced exercises the skip-mode step
    signature, grid recomputation at occupancy updates, and the metrics
    plumbing end-to-end."""
    train_rays, _ = pools
    mesh = make_mesh(jax.devices()[:2])
    cfg = tiny_cfg(tmp_path, method="kplanes", steps=3, march="skip")
    out = train(cfg, train_rays, mesh=mesh)
    assert len(out["train_metrics"]) == 3
    assert all(np.isfinite(m.loss) for m in out["train_metrics"])


def test_train_learns_smoke(pools, tmp_path):
    """Fast-tier guard that training actually reduces the loss (loose bound,
    few steps) — the full assertion lives in the slow-tier
    test_train_actually_learns; without this, a change that silently stops
    learning would pass the default `-m 'not slow'` run (ADVICE r4)."""
    train_rays, _ = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(
        tmp_path, method="kplanes", batch_size=128, n_samples=32, steps=20,
        occupancy_update_every=1000, ray_buckets=(1,),
    )
    out = train(cfg, train_rays, mesh=mesh)
    losses = [m.loss for m in out["train_metrics"]]
    first = float(np.mean(losses[:3]))
    last = float(np.mean(losses[-5:]))
    assert last < 0.85 * first, f"no learning: first={first:.5f} last={last:.5f}"


def test_resume_shard_layout_mismatch(pools, tmp_path):
    """A shard_tables checkpoint embeds a mesh-size-dependent optimizer
    layout; resuming under a different mesh size or shard setting must fail
    with a descriptive error, not an opaque tree/shape error (ADVICE r4)."""
    train_rays, _ = pools
    # 2-device mesh: the layout-mismatch validation is mesh-size-agnostic
    # (it compares recorded vs current n_shards/shard_tables at LOAD time,
    # before any step compiles) and the 8-device shard step is already
    # compiled by test_zero; 2 devices halves this test's CPU compile
    mesh2 = make_mesh(jax.devices()[:2])
    cfg = tiny_cfg(tmp_path, method="kplanes", steps=1, checkpoint_every=1,
                   shard_tables=True)
    train(cfg, train_rays, mesh=mesh2)

    mesh1 = make_mesh(jax.devices()[:1])
    cfg2 = tiny_cfg(tmp_path, method="kplanes", steps=2, shard_tables=False)
    with pytest.raises(ValueError, match="shard_tables"):
        train(cfg2, train_rays, mesh=mesh1, resume=True)

    # replicated checkpoints stay resumable across mesh sizes
    cfg3 = tiny_cfg(tmp_path / "rep", method="vanilla", steps=1,
                    checkpoint_every=1)
    train(cfg3, train_rays, mesh=mesh1)
    cfg4 = tiny_cfg(tmp_path / "rep", method="vanilla", steps=2)
    out = train(cfg4, train_rays, mesh=mesh2, resume=True)
    assert len(out["train_metrics"]) == 1


@pytest.mark.slow
def test_train_actually_learns(pools, tmp_path):
    """~60 CPU steps must materially reduce the loss — guards against a
    change that keeps everything finite but silently stops learning (the
    gap VERDICT r2 flagged: every other train test only checks
    isfinite)."""
    train_rays, _ = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(
        tmp_path, method="kplanes", batch_size=128, n_samples=32, steps=60,
        occupancy_update_every=1000,  # fixed demand: one compiled step
        ray_buckets=(1,),
    )
    out = train(cfg, train_rays, mesh=mesh)
    losses = [m.loss for m in out["train_metrics"]]
    assert len(losses) == 60
    first = float(np.mean(losses[:5]))
    last = float(np.mean(losses[-10:]))
    assert last < 0.5 * first, f"no learning: first={first:.5f} last={last:.5f}"


@pytest.mark.slow
def test_eval_timeline_recorded(pools, tmp_path):
    """With eval_every set, train() records a (step, wall-clock, psnr)
    timeline — the data behind the time-to-X-PSNR metric."""
    train_rays, test_set = pools
    mesh = make_mesh(jax.devices()[:1])
    cfg = tiny_cfg(tmp_path, steps=5, eval_every=2, eval_n=1)
    out = train(cfg, train_rays, eval_set=test_set, test_set=None, mesh=mesh)
    tl = out["eval_timeline"]
    assert len(tl) == 2  # steps 2 and 4
    assert all(e["elapsed_s"] > 0 and np.isfinite(e["psnr"]) for e in tl)
    assert [e["step"] for e in tl] == [2, 4]
    assert (cfg.output / "eval_timeline.json").exists()
