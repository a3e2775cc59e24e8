"""Training configuration.

Parity: TrainConfig (reference src/run.py:83-94) plus the hardcoded
hyperparameters of the reference train() (src/run.py:100-114) surfaced as
overridable fields, all scaled by the same bs_ratio = 4096 / batch_size rule.
Additions: compute dtype, the fixed sample-buffer capacity
policy, and candidate-ray bucket multipliers (the static-shape counterpart of
the reference's dynamic constant-sample batching).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple


@dataclass
class TrainConfig:
    method: str = "kplanes"  # vanilla | kplanes | cobafa
    scene_type: str = "aabb"  # aabb | unbounded
    output: Path = Path("output")

    batch_size: int = 2048  # target rays/step (defines the sample budget)
    n_samples: int = 400  # marcher samples per ray

    eval_every: Optional[int] = None
    eval_n: Optional[int] = None

    seed: int = 0

    # ---- schedule (reference defaults; None = derive from bs_ratio)
    steps: Optional[int] = None  # default 2048 * bs_ratio
    occupancy_update_every: Optional[int] = None  # default 16 * bs_ratio
    occupancy_res: int = 128
    occupancy_threshold: float = 0.01
    # decay: a voxel must be seen empty 16 times to die (0.01 ** (1/16))
    occupancy_decay: Optional[float] = None
    # query interpolation: "nearest" (Instant-NGP standard, 1 gather/point) or
    # "trilinear" (the reference's grid_sample semantics, src/core.py:151)
    occupancy_interp: str = "nearest"

    # True = apply weight decay to raw feature tables too (the reference
    # decays everything, src/run.py:186); False (default) masks tables out of
    # decay — under Adam a constant decay direction on sparsely-supervised
    # table cells steps at full lr and flattens the tables (field collapse)
    decay_tables: bool = False

    # None = method-dependent default: 1e-2 for K-Planes (reference value,
    # src/run.py:110), 1e-3 for vanilla and 3e-3 for cobafa — the reference
    # hardcodes 1e-2 for ALL methods, but that is destructively high when an
    # MLP carries the field (800-step A/B on the spheres scene:
    # vanilla 11.6 dB stuck at 1e-2 vs 27.2 dB at 1e-3; cobafa swept
    # 3e-4/1e-3/3e-3 -> 16.9/21.8/26.1 dB — plausibly why the reference
    # never achieved its Cobafa reproduction)
    lr_init: Optional[float] = None
    # optional SPLIT learning rate for raw feature tables (planes/grids):
    # tables tolerate (and often need) a much higher rate than the MLPs that
    # decode them — the reference's single flat 1e-2 is exactly the
    # compromise that breaks its Cobafa reproduction.  None = method default
    # (cobafa: 1e-2 tables / 3e-3 mlp, swept: 29.0 dB vs 26.1
    # flat; other methods: same as lr).
    lr_tables: Optional[float] = None
    adam_eps: float = 1e-15
    weight_decay: float = 1e-5
    tv_reg_alpha: float = 1e-4  # kplanes only
    l1_reg_alpha: float = 0.0  # kplanes only
    lr_milestones: Tuple[float, ...] = (0.5, 0.75, 5.0 / 6.0, 0.9)
    lr_gamma: float = 0.33

    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (-1.5, -1.5, -1.5),
        (1.5, 1.5, 1.5),
    )
    near: float = 0.1

    # ---- static-shape execution
    compute_dtype: str = "bfloat16"  # bfloat16 | float32 (MLP matmul dtype; fp32 masters.
    # Full-schedule A/B on the spheres scene: bf16 33.28 dB vs f32 33.03 -- neutral)
    # candidate-ray bucket multipliers: per step the host picks the largest
    # bucket whose expected sample demand fits the fixed cap; each bucket is
    # one compiled program (static shapes). Large multipliers engage late in
    # training when occupancy has converged to thin shells (few samples/ray).
    ray_buckets: Tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 20, 24, 32, 48, 64)
    # optional ceiling on the bucket ladder (None = unlimited).  The
    # constant-sample batching faithfully implements the reference's
    # semantics (src/run.py:205-244), but on TINY datasets the converged
    # ladder can reach effective batches larger than the training set —
    # a 24x effective-batch jump cost ~3 dB of test PSNR on a 12-view proxy
    # scene (overfit).  Cap rays/step at
    # max_bucket * batch_size for such datasets; full-size scenes should
    # leave this None (the ladder is where the throughput lives).
    max_bucket: Optional[int] = None
    # candidate demand may exceed the cap by this factor: rays that spill past
    # the cap are excluded from the loss (renderer.render_packed ray_valid),
    # so slight overfill trades a few dropped tail rays for full buffer
    # utilization between bucket steps
    bucket_overfill: float = 1.15
    early_termination: float = 1e-4
    # field spatial-capacity scale (models/registry.py): scales table
    # resolutions / MLP width while preserving field structure (scale count,
    # feature dims, K-Planes' 2r-1 nesting).  1.0 = the reference
    # configuration; small values (tests, smoke runs) compile in seconds.
    field_scale: float = 1.0
    # truncated_exp forward clamp (ops/trunc_exp.py): True = clamp the
    # FORWARD at exp(15) too (inf-guard; A/B-neutral on quality);
    # False = the reference's unclamped forward (src/models.py:47)
    fwd_clamp: bool = True
    # ZeRO-1-style sharded-table training (parallel/zero.py): on a multi-
    # device mesh, table gradients are psum_scatter'd, Adam moments for the
    # tables live sharded (memory and optimizer work divide by the mesh),
    # the TV/L1 regularizer computes row-partitioned per device, and updated
    # table slices all_gather back.  Same total collective bytes per step as
    # plain psum DP, without the table-sized replicated work.  No-op on one
    # device or for
    # fields with no declared tables.  NOTE: checkpoints carry the sharded
    # optimizer-state layout — resume with the same mesh size + setting.
    shard_tables: bool = False
    # extend sharded-table training into the backward itself: the fused
    # K-Planes backward
    # psum_scatters the device-summed FINE table gradient and each device
    # pulls back only its row band through the upsample transpose
    # (ops/interp.py _sharded_pullback), so the table-sized pullback compute
    # divides by the mesh instead of replicating.  Per-device grads become
    # partials that the existing reductions sum exactly — equality with the
    # replicated step is enforced in tests/test_zero.py.  Requires
    # shard_tables, a multi-device mesh, and the fused K-Planes lookup;
    # silently no-ops otherwise.
    shard_bwd: bool = False
    # marching strategy: "auto" picks the empty-space-skipping marcher
    # (core/skipmarch.py) whenever the scene supports it AND the demand
    # estimate leaves ample step budget (early training = dense); "dense" /
    # "skip" force one path.  skip_steps = scan-step budget per ray.
    march: str = "auto"  # auto | dense | skip
    # scan-step budget per ray (None = scene-type default: 64 for AABB, 96
    # for unbounded — the disparity tail needs ~1.5x the rounds under the
    # exact far-field Lipschitz certificate; 100% ray completeness on the
    # bench's shell geometry at 96, 80% at 64, measured)
    skip_steps: Optional[int] = None
    # rematerialize the feature field in the backward pass (trades one extra
    # field forward for not holding per-layer activations of sample_cap
    # points in device memory).  None = auto: when the vanilla MLP's saved
    # activations would exceed half the device's memory (train/loop.py
    # _remat_auto); True/False force it.
    remat_field: Optional[bool] = None
    # checkpointing cadence (0 = only at the end); resume picks up latest
    checkpoint_every: int = 0
    # profiling: capture a jax.profiler trace of steps [start, start+count)
    # into <output>/trace (None disables).  View with TensorBoard.
    profile_start: Optional[int] = None
    profile_count: int = 5
    # eval/serving render path: "packed" routes full-image rendering through
    # the training path's fixed-capacity compaction (+ empty-space-skip
    # marching when the scene supports it) — the field MLPs run on the
    # surviving samples only (~5% of the dense count at converged occupancy)
    # instead of chunk * n_samples brute-force positions (the reference's
    # eval, src/run.py:15-50).  Rays that overflow the eval cap or exhaust
    # the skip budget are re-rendered by the dense path, so "packed" is an
    # optimization, never an approximation.  "dense" forces brute force.
    eval_render: str = "packed"  # packed | dense
    # per-ray sample capacity of the packed eval buffer (cap = chunk * this);
    # overflowing rays fall back to the dense path per chunk
    eval_samples_per_ray: int = 64

    @property
    def effective_skip_steps(self) -> int:
        if self.skip_steps is not None:
            return self.skip_steps
        return 96 if self.scene_type == "unbounded" else 64

    @property
    def effective_lr(self) -> float:
        if self.lr_init is not None:
            return self.lr_init
        if self.method == "vanilla":
            return 1e-3
        if self.method == "cobafa":
            return 3e-3
        return 1e-2

    @property
    def effective_lr_tables(self) -> Optional[float]:
        if self.lr_tables is not None:
            return self.lr_tables
        return 1e-2 if self.method == "cobafa" else None

    @property
    def bs_ratio(self) -> float:
        return 4096.0 / self.batch_size

    @property
    def total_steps(self) -> int:
        return self.steps if self.steps is not None else int(2048 * self.bs_ratio)

    @property
    def occ_update_every(self) -> int:
        if self.occupancy_update_every is not None:
            return self.occupancy_update_every
        return max(1, int(16 * self.bs_ratio))

    @property
    def occ_decay(self) -> float:
        if self.occupancy_decay is not None:
            return self.occupancy_decay
        return self.occupancy_threshold ** (1.0 / 16.0)

    @property
    def sample_cap(self) -> int:
        """Fixed per-step sample budget = batch_size * n_samples."""
        return self.batch_size * self.n_samples
