"""Frozen copy of the port's configuration dataclasses (model and
training recipe), without the YAML overlay."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

@dataclass(frozen=True)
class Backbone2DConfig:
    # reference: config/default.py:65-66 ('fpn-mnas-1' -> alpha=1.0)
    arc: str = "fpn-mnas-1"

    @property
    def alpha(self) -> float:
        return float(self.arc.split("-")[-1])


@dataclass(frozen=True)
class PanopticConfig:
    """Panoptic decoder hyperparameters (reference: models/neucon_network.py:60-97)."""
    num_classes: int = 20
    num_queries: int = 80
    hidden_dim: int = 48
    nheads: int = 8
    dec_layers: int = 6
    dim_feedforward_mult: int = 4
    # set-criterion weights (reference models/criterion.py)
    class_weight: float = 0.2
    mask_weight: float = 0.8
    dice_weight: float = 0.8
    no_object_weight: float = 0.1
    # static slots of GT instances per fragment
    max_instances: int = 48
    # GT instances with this many voxels or fewer are dropped
    min_instance_voxels: int = 100


@dataclass(frozen=True)
class ModelConfig:
    n_vox: Tuple[int, int, int] = (96, 96, 96)
    voxel_size: float = 0.04
    n_layer: int = 3
    thresholds: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # occupancy BCE positive weight, and the loss weights over
    # (tsdf_occ_loss_0, 1, 2, panoptic) (reference models/neuralrecon.py:79-84)
    pos_weight: float = 1.5
    lw: Tuple[float, ...] = (1.0, 0.8, 0.64, 1.2)
    # BGR pixel mean/std (reference config/default.py:60-61)
    pixel_mean: Tuple[float, float, float] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # dropout at the U-Net's L2 in training (JAX eprecon_tpu/models/
    # unet_dense.py:76-77); True is refused when the model is built
    sparsereg_dropout: bool = False
    backbone2d: Backbone2DConfig = field(default_factory=Backbone2DConfig)
    panoptic: PanopticConfig = field(default_factory=PanopticConfig)
    # occupancy initialization (reference models/neucon_network.py:239-244)
    init_stage: int = 1
    min_view_number: int = 2
    occ_init_threshold: float = 0.3
    # fragment flagged not-ok below these active-voxel counts
    min_init_voxels: int = 1000
    min_stage_voxels: int = 500
    # static voxel capacities per stage (coarse->fine) of the compacted
    # panoptic voxel sets
    voxel_capacity: Tuple[int, int, int] = (16384, 65536, 131072)
    # dense global scene volume extent in FINEST-level voxels; coarser
    # levels are this / 2^scale. (256, 256, 128) @ 4 cm = 10.2 x 10.2 x 5.1 m
    global_extent: Tuple[int, int, int] = (256, 256, 128)
    # "window_union": anchor the global volume at the scene's minimum
    # fragment-window origin when the caller knows it; else at vol_origin
    scene_anchor: str = "window_union"
    # margin (finest voxels) the global volume keeps below a scene origin
    origin_margin: int = 32
    # storage dtype of the recurrent global feature volumes
    global_dtype: str = "bfloat16"
    # round float images to uint8 before the forward (the JAX package's
    # host->device transfer format; the cast to f32 happens in normalize)
    transfer_images_uint8: bool = False
    # size global_extent and origin_margin from the dataset's fragment
    # windows at run_train/run_test start-up (data/extent.py)
    global_extent_auto: bool = False
    # the reference's per-stage voxel sample caps (config/train.yaml)
    train_num_sample: Tuple[int, int, int] = (15000, 60000, 120000)
    test_num_sample: Tuple[int, int, int] = (15000, 60000, 120000)
    # what the training backward recomputes instead of keeping (read as the
    # JAX package reads it; models/layers.remat): "full" the two backbones,
    # the occupancy init, each stage's U-Net, the GRU convs and the
    # decoder; "none" nothing; any other value, "light" included, the two
    # backbones. Only where autograd records: inference and export hold no
    # recompute. Results are the same in every mode, memory and time not.
    remat_mode: str = "light"

    @property
    def n_scales(self) -> int:
        return len(self.thresholds) - 1


@dataclass(frozen=True)
class TrainConfig:
    """Data, loop and optimizer recipe of training (reference
    config/train.yaml TRAIN and main.py:154-348): Adam, MultiStepLR, grad
    clip, gradient accumulation, staged freezing, world-frame
    augmentation."""
    path: str = ""
    epochs: int = 100
    lr: float = 1e-4
    lr_epochs: str = "70,90:10"   # milestones (epochs) : lr divisor
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip: float = 1.0
    n_views: int = 9
    n_workers: int = 8
    accumulation_steps: int = 8
    random_rotation_3d: bool = True
    random_translation_3d: bool = True
    pad_xy_3d: float = 0.1
    pad_z_3d: float = 0.025
    only_init: bool = False       # train the occupancy initialization alone
    # scene-granularity shuffling of the sharded loop (fragments stay in
    # temporal order within a scene)
    shuffle: bool = False
    finetune_layer: Optional[str] = None  # 'init': freeze backbone2d + init
    seed: int = 1
