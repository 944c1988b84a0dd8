"""Configuration tree for the PyTorch port of QED-Splatter.

A field-for-field copy of ``qed_splatter_tpu.configs`` (plain dataclasses,
so the two packages read the same checkpoints' metadata and the tests can
hand one config's values to both). Fields that only steer JAX/TPU mechanics
keep their names and defaults; their meaning in the port:

- ``use_pallas``: run the hand-written CUDA kernels (on CUDA tensors; the
  plain PyTorch versions on CPU tensors). ``False`` selects the plain
  compositor over id lists (``ops.rasterize.rasterize_tiles``) and the plain
  window gather explicitly, as the JAX package selects its XLA path.
- ``pallas_interpret``, ``grow_memory_fraction``: no effect in the port
  (capacity growth reverts on a CUDA out-of-memory error instead of a
  compile probe's memory estimate).
- ``TrainerConfig.max_device_cache_bytes``: the budget of the trainer's
  per-camera batches kept on the device, and the test of whether the image
  cache of multi-step dispatch fits (the JAX trainer's).
- ``TrainerConfig.steps_per_dispatch``: 0 picks the chunk as the JAX
  trainer does, 1 is the per-step loop, N > 1 runs chunks of N steps, each
  a CUDA graph of the step replayed per step (``engine/scan_runner.py``).
- ``TrainerConfig.supervise``, ``max_restarts``: ``cli train``'s restart
  loop; ``journal_retry``: the crash policy's amnesty
  (``engine/journal.py``).
- ``TrainerConfig.viewer_port``: the port of the viewer's HTTP server with
  ``vis="viewer"`` (0 picks a free one).
- ``TrainerConfig.num_data_shards`` / ``num_model_shards``: the mesh of
  ``torch.distributed`` ranks (``parallel/mesh.py``; ``cli train`` starts
  D x M ranks on the host, or joins a ``torchrun`` job);
  ``shard_views_by_process``: each host trains on every host-count-th
  camera, keyed on the host (torchrun's ``GROUP_RANK``), not the rank: a
  JAX process is a host, and the ranks of one host draw the same cameras.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """QEDSplatterModelConfig + inherited SplatfactoModelConfig fields.

    Reference: model.py:41-47 (qed overrides), config.py:40-41 (method
    overrides), SURVEY D8 (splatfacto defaults).
    """

    # --- qed-splatter additions (model.py:41-47) ---
    depth_lambda: float = 0.2            # depth-L1 weight; 0.2-0.3 works well
    output_depth_during_training: bool = True

    # --- splatfacto core (SURVEY D8 defaults; overrides config.py:40-41) ---
    warmup_length: int = 500             # steps before densification starts
    refine_every: int = 100              # densify/cull cadence
    resolution_schedule: int = 3000      # steps per coarse-to-fine doubling
    background_color: Literal["random", "black", "white"] = "random"
    num_downscales: int = 2              # start at 1/2^2 resolution
    cull_alpha_thresh: float = 0.005     # reference config.py:40
    cull_scale_thresh: float = 0.5       # world-space cull threshold
    continue_cull_post_densification: bool = True
    reset_alpha_every: int = 30          # x refine_every steps
    densify_grad_thresh: float = 0.0005  # reference config.py:41
    densify_size_thresh: float = 0.01    # split/dup size boundary
    n_split_samples: int = 2             # gaussians per split
    sh_degree_interval: int = 1000       # model.py:262
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    random_init: bool = False
    num_random: int = 50_000
    random_scale: float = 10.0           # model.py:45 knob (100.0 for unscaled)
    ssim_lambda: float = 0.2
    stop_split_at: int = 15_000
    sh_degree: int = 3
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    rasterize_mode: Literal["classic", "antialiased"] = "classic"
    # camera pose optimization (SURVEY D10; config.py:69-74)
    camera_opt_mode: Literal["off", "SO3xR3"] = "SO3xR3"
    use_bilateral_grid: bool = False     # model.py:47 (needs ns 1.1.3)
    bilateral_grid_shape: Tuple[int, int, int] = (16, 16, 8)

    # --- TPU-native knobs (no reference counterpart) ---
    tile_size: int = 16                  # model.py:243 BLOCK_WIDTH
    max_per_tile: int = 512              # fixed-K per-tile compositing cap
    init_capacity_headroom: float = 4.0  # capacity = headroom * seed points
    max_capacity: int = 4_194_304        # hard ceiling for densification
    # Capacity growth is committed only after the grown-capacity train step
    # (and refine) AOT-compile and their XLA memory analysis fits within
    # this fraction of the device's HBM. A growth that would OOM (or fail
    # to compile) is refused — the priority-capped densifier then operates
    # at the current capacity — instead of killing the TPU worker
    # mid-run (observed: the 1.79M->3.58M growth of the round-3 room run).
    grow_memory_fraction: float = 0.9
    near_plane: float = 0.01             # model.py:279
    far_plane: float = 1e10              # model.py:280
    use_pallas: bool = True              # pallas kernels on TPU, XLA elsewhere
    # grow max_per_tile (x2, up to the limit) when the tile_overflow metric
    # shows the K cap truncating >10% of per-tile intersections. ON by
    # default: the reference's dynamic pair lists have no cap, and a
    # saturated cap keeps only the NEAREST K per tile — measured to
    # truncate away whole surfaces on dense scenes, near-biasing depth and
    # feeding a truncation->error->densify runaway (round-2 finding; the
    # fix restored depth abs_rel 0.28 -> 0.03 on the room benchmark).
    # Costs a bounded number of recompiles (K at most doubles
    # log2(limit/512) times).
    adaptive_max_per_tile: bool = True
    max_per_tile_limit: int = 4096
    # hierarchical pair-expansion budget (ops.tiles): every gaussian gets
    # this many tile-pair slots; bigger splats compete for a bounded
    # overflow table. The trainer escalates it per resolution bucket
    # (x2, up to max_tiles_per_gaussian) when the bbox_truncated metric
    # shows >0.5% of alive splats losing bbox cells — the round-5
    # config-2 collapse: at 1/1 res after coarse-res training, ~20% of
    # 614k splats exceeded 8 cells, and a truncated splat keeps an
    # arbitrary top-rows subset of its bbox (banding artifacts, train
    # PSNR 33 -> 16).
    small_tiles_per_gaussian: int = 8
    max_tiles_per_gaussian: int = 64
    adaptive_pair_budget: bool = True
    # run the Pallas kernels in interpret mode off-TPU (tests / multichip
    # dryrun exercise the exact hot-path code a TPU pod would run)
    pallas_interpret: bool = False
    # bf16 operands in the compositing kernels during training (synced
    # from TrainerConfig.mixed_precision, reference config.py:32); eval
    # renders stay f32
    mixed_precision: bool = False
    # zero non-finite gradient elements before the Adam update and report
    # their count as the ``nonfinite_grads`` train metric. Last line of
    # defense: a single inf/NaN grad element otherwise propagates through
    # Adam into the parameters permanently (the torch reference surfaces
    # this as a visible loss=NaN the user reacts to; an unattended TPU run
    # must contain it instead).
    sanitize_grads: bool = True
    # optional per-group global-norm gradient clip (0 = off, reference
    # parity: nerfstudio does not clip splatfacto gradients)
    grad_clip_norm: float = 0.0


@dataclass(frozen=True)
class AdamConfig:
    """AdamOptimizerConfig + ExponentialDecaySchedulerConfig (reference
    config.py:44-81; SURVEY D9). lr_final None = constant lr."""

    lr: float = 1e-3
    eps: float = 1e-15
    lr_final: Optional[float] = None
    max_steps: int = 30_000
    warmup_steps: int = 0
    lr_pre_warmup: float = 1e-8


def default_optimizers() -> dict:
    """The eight per-group optimizers, verbatim from reference config.py:44-81."""
    return {
        "means": AdamConfig(lr=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
        "features_dc": AdamConfig(lr=2.5e-3),
        "features_rest": AdamConfig(lr=2.5e-3 / 20.0),
        "opacities": AdamConfig(lr=5e-2),
        "scales": AdamConfig(lr=5e-3),
        "quats": AdamConfig(lr=1e-3),
        "camera_opt": AdamConfig(
            lr=1e-4, lr_final=5e-7, max_steps=30_000,
            warmup_steps=1000, lr_pre_warmup=0.0,
        ),
        "bilateral_grid": AdamConfig(
            lr=2e-3, lr_final=1e-4, max_steps=30_000,
            warmup_steps=1000, lr_pre_warmup=0.0,
        ),
    }


@dataclass(frozen=True)
class DataConfig:
    """Dataparser + datamanager configuration (reference dataparser.py:13-18,
    config.py:33-38; SURVEY D7/D12)."""

    data: str = ""                        # dataset dir or transforms.json
    depth_unit_scale_factor: float = 0.001  # mm -> m (dataparser.py:15)
    load_3D_points: bool = True             # config.py:36
    auto_scale_poses: bool = True           # off for unscaled scenes (README:20-25)
    center_method: Literal["poses", "focus", "none"] = "poses"
    orientation_method: Literal["pca", "up", "vertical", "none"] = "up"
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    train_split_fraction: float = 0.9
    eval_mode: Literal["fraction", "interval", "all"] = "fraction"
    eval_interval: int = 8
    cache_images_type: Literal["uint8", "float32"] = "uint8"  # config.py:37
    downscale_factor: Optional[int] = None  # dataset-level image downscale
    max_images: Optional[int] = None        # debug subsetting


@dataclass
class TrainerConfig:
    """Reference TrainerConfig (config.py:25-84) + TPU runtime knobs."""

    method_name: str = "qed-splatter"
    steps_per_eval_image: int = 100
    steps_per_eval_batch: int = 0
    steps_per_save: int = 2000
    steps_per_eval_all_images: int = 1000
    max_num_iterations: int = 30_000
    mixed_precision: bool = False        # config.py:32; bf16 path when True
    output_dir: str = "outputs"
    experiment_name: Optional[str] = None
    load_dir: Optional[str] = None       # checkpoint resume
    seed: int = 42
    vis: Literal["none", "tensorboard", "jsonl", "viewer", "wandb", "comet"] = "jsonl"
    viewer_port: int = 7007              # ViewerConfig (config.py:82)
    log_every: int = 10
    # tracing on (tracing.py) and a torch.profiler trace of steps 10..14
    # (per-step loop) or of the first chunk from step 10 on (multi-step
    # dispatch), with the chunk's callbacks
    profile_dir: Optional[str] = None
    # steps per device dispatch: 0 = auto (gcd of the cadence settings,
    # capped at 100), 1 = the per-step host loop. Multi-step dispatch
    # replays a CUDA graph of the step once per step, on a device-resident
    # image cache (engine.scan_runner)
    steps_per_dispatch: int = 0
    max_device_cache_bytes: int = 4 << 30  # fall back to host loop beyond
    # --- divergence containment (no reference counterpart: the torch
    # reference shows loss=NaN to a watching user; an unattended run must
    # detect, halt, or roll back on its own) ---
    # "rollback": restore the last finite checkpoint, freeze densification
    # for divergence_freeze_steps, continue (up to max_rollbacks, then
    # halt); "halt": save a post-mortem checkpoint and raise;
    # "ignore": legacy behavior (log only).
    on_divergence: Literal["halt", "rollback", "ignore"] = "rollback"
    max_rollbacks: int = 3
    divergence_freeze_steps: int = 500
    # --- crash supervision (no reference counterpart: a CUDA OOM is a
    # recoverable exception, but a lost context (an illegal address, a
    # launch failure, a device-side assert) takes the process with it, and
    # only a restart recovers) ---
    # supervise=True wraps training in a restart loop: on a child crash the
    # run resumes from its last checkpoint with the crashed configuration
    # refused by the attempt journal (engine.journal).
    supervise: bool = False
    max_restarts: int = 5
    # Crash-policy amnesty (VERDICT r4 weak #4): a single unmatched journal
    # attempt may be a co-tenant process stealing the shared chip, not
    # deterministic OOM evidence — permanent refusal after one kill silently
    # caps quality forever (the r4 run's K=512 cap cost ~4 dB). A crashed
    # configuration is re-attempted on restart until it has crashed MORE
    # than journal_retry times; the same config dying again raises its
    # count past the budget and it stays refused on every later restart.
    # journal_retry=0 restores the old refuse-on-first-crash behavior.
    journal_retry: int = 1

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimizers: dict = field(default_factory=default_optimizers)

    # --- parallelism (SURVEY §2c; no reference counterpart) ---
    num_data_shards: int = 1     # mesh 'data' axis: cameras per step
    num_model_shards: int = 1    # mesh 'model' axis: gaussian sharding
    shard_views_by_process: bool = True  # multi-host: per-host camera subset


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
