"""A reference conf tree in the upstream's Hydra / Torch-Points3D YAML DSL,
written for the ``test_torch_port_*`` ingest tests: block-style model
entries (``define_constants`` arithmetic, flow sequences over several
lines, per-modality ``image`` subtrees, block sequences of modules) and a
multimodal S3DIS data file with a ``defaults:`` base and ``${data....}``
interpolations.  The entries are shaped like the published ones at test
sizes; they are not copies of them."""

from __future__ import annotations

from pathlib import Path

# conf/models/segmentation/multimodal/sparseconv3d.yaml
SPARSE_MM = """\
# Multimodal sparse-convolution entries (test fixture)
defaults:
    - /models/segmentation/default

Res16UNet34-L4-early-ade20k-interpolate:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
        define_constants:
            in_feat: 32
            block: ResBlock
            mod_in_feat: 512
        down_conv:
            module_name: ResNetDown
            block: block
            conv3d_after_fusion: False
            N: [0, 2, 3, 4, 6]
            down_conv_nn:
                [
                    [FEAT + mod_in_feat, in_feat],
                    [in_feat, in_feat],
                    [in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
            image:
                down_conv:
                    module_name: ADE20KResNet18TruncatedLayer4
                    frozen: False
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name: GroupBimodalCSRPool
                    in_map: 8
                    in_mod: mod_in_feat
                    num_groups: 4
                    use_mod: False
                    gating: True
                    group_scaling: True
                    map_encoder: DeepSetFeat
                    use_num: True
                fusion:
                    module_name: BimodalFusion
                    mode: concatenation
                branching_index: 0
                interpolate: True
        up_conv:
            module_name: ResNetUp
            block: block
            N: [1, 1, 1, 1, 1]
            up_conv_nn:
                [
                    [8*in_feat, 4*in_feat, 8*in_feat],
                    [8*in_feat, 2*in_feat, 4*in_feat],
                    [4*in_feat, in_feat, 3*in_feat],
                    [3*in_feat, in_feat, 3*in_feat],
                    [3*in_feat, 0, 3*in_feat],
                ]
            kernel_size: [2, 2, 2, 2, 3]
            stride: [2, 2, 2, 2, 1]

Res16UNet14-Res16Image-max:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
        define_constants:
            in_feat: 32
            block: ResBlock
        down_conv:
            module_name: ResNetDown
            block: block
            conv3d_after_fusion: False
            N: [0, 1, 1, 1, 1]
            down_conv_nn:
                [
                    [FEAT + 32, in_feat],
                    [in_feat + 32, in_feat],
                    [in_feat + 64, 2*in_feat],
                    [2*in_feat + 128, 4*in_feat],
                    [4*in_feat + 256, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
            image:
                down_conv:
                    module_name: ResNetDown
                    block: ResBlock
                    N: [0, 2, 2, 2, 2]
                    down_conv_nn:
                        [
                            [3, 32],
                            [32, 32],
                            [32, 64],
                            [64, 128],
                            [128, 256],
                        ]
                    kernel_size: [3, 3, 3, 3, 3]
                    stride: [1, 2, 2, 2, 2]
                    normalization: GroupNorm
                    weight_standardization: True
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name:
                        - BimodalCSRPool
                        - GroupBimodalCSRPool
                        - BimodalCSRPool
                        - BimodalCSRPool
                        - BimodalCSRPool
                    mode: max
                    num_groups: 4
                fusion:
                    module_name: BimodalFusion
                    mode: concatenation
                branching_index: [0, 2, 3, 4, 5]
                interpolate: True

Res16UNet14-L4-all:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
        define_constants:
            in_feat: 32
            mod_feat: 64
            l4: 512
        down_conv:
            module_name: ResNetDown
            conv3d_after_fusion: False
            N: [0, 1, 1, 1, 1]
            down_conv_nn:
                [
                    [FEAT + mod_feat, in_feat],
                    [in_feat, in_feat],
                    [in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
            image:
                down_conv:
                    module_name:
                        - ResNet18TruncatedLayer4
                        - ModalityIdentity
                        - ModalityIdentity
                atomic_pooling:
                    mode: max
                view_pooling:
                    module_name: GroupBimodalCSRPool
                    in_mod: [l4, l4, l4]
                    out_mod: [mod_feat, in_feat, 2*in_feat]
                    num_groups: 4
                    use_num: True
                fusion:
                    mode: [concatenation, residual, residual]
                branching_index: [0, 2, 4]
                interpolate: True

Res16UNet14-RGB-identity-early:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
        define_constants:
            in_feat: 32
        down_conv:
            module_name: ResNetDown
            conv3d_after_fusion: False
            N: [0, 1, 1, 1, 1]
            down_conv_nn:
                [
                    [FEAT + 3, in_feat],
                    [in_feat, in_feat],
                    [in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
            image:
                down_conv:
                    module_name: ModalityIdentity
                atomic_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                view_pooling:
                    module_name: BimodalCSRPool
                    mode: max
                fusion:
                    module_name: BimodalFusion
                    mode: concatenation
                branching_index: 0
                interpolate: True

Res16UNet34-PointPyramid-early-cityscapes-interpolate:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
        define_constants:
            in_feat: 32
        down_conv:
            module_name: ResNetDown
            n_early_conv: 5
            conv3d_after_fusion: False
            N: [0, 2, 3, 4, 6]
            down_conv_nn:
                [
                    [FEAT + 512, in_feat],
                    [in_feat, in_feat],
                    [in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
            image:
                down_conv:
                    module_name:
                        - CityscapesResNet18TruncatedLayer0
                        - CityscapesResNet18TruncatedLayer1
                        - CityscapesResNet18TruncatedLayer2
                        - CityscapesResNet18TruncatedLayer3
                        - CityscapesResNet18TruncatedLayer4
                atomic_pooling:
                    mode: max
                view_pooling:
                    module_name: GroupBimodalCSRPool
                    in_mod: [128, 64, 128, 256, 512]
                    out_mod: [32, 32, 64, 128, 256]
                    num_groups: 4
                    use_num: True
                fusion:
                    mode: concatenation
                branching_index: [0, 1, 2, 3, 4]
                interpolate: True

Res16UNet21-15-custom:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone:
        define_constants:
            in_feat: 32
            s2: 2
        down_conv:
            module_name: ResNetDown
            N: [0, 0, 2, 0, 3, 0, 4, 0, 1]
            down_conv_nn:
                [
                    [FEAT, in_feat],
                    [in_feat, in_feat], [in_feat, in_feat],
                    [in_feat, 2*in_feat], [2*in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat], [4*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat], [8*in_feat, 8*in_feat],
                ]
            kernel_size: [5, 2, 3, 2, 3, 2, 3, 2, 3]
            stride: [1, s2, 1, s2, 1, s2, 1, s2, 1]
        up_conv:
            module_name: ResNetUp
            N: [1, 1, 1, 1, 2]
            up_conv_nn:
                [
                    [8*in_feat, 4*in_feat, 4*in_feat],
                    [4*in_feat, 2*in_feat, 4*in_feat],
                    [4*in_feat, in_feat, 3*in_feat],
                    [3*in_feat, in_feat, 3*in_feat],
                    [3*in_feat, 0, 3*in_feat],
                ]
            stride: [2, 2, 2, 2, 1]

XYZ-RGB-PPM-late:
    class: sparseconv3d.LateFeatureFusion
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone_3d:
        define_constants:
            in_feat: 32
        down_conv:
            module_name: ResNetDown
            N: [0, 2, 3, 4, 6]
            down_conv_nn:
                [
                    [FEAT, in_feat],
                    [in_feat, in_feat],
                    [in_feat, 2*in_feat],
                    [2*in_feat, 4*in_feat],
                    [4*in_feat, 8*in_feat],
                ]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
    backbone_no3d:
        define_constants:
            mod_out: 512
        down_conv:
            image:
                down_conv:
                    module_name: ADE20KResNet18PPM
                atomic_pooling:
                    mode: max
                view_pooling:
                    module_name: GroupBimodalCSRPool
                    in_mod: 128
                    out_mod: mod_out
                    num_groups: 8
                    map_encoder: MinMaxDiffSetFeat
                interpolate: True

XYZ-RGB-L4-late-logit-QKV:
    class: sparseconv3d.LateLogitFusion
    conv_type: "SPARSE"
    backend: "minkowski"
    backbone_3d:
        down_conv:
            module_name: ResNetDown
            N: [0, 1, 1, 1, 1]
            down_conv_nn: [[FEAT, 32], [32, 32], [32, 64], [64, 128], [128, 256]]
            kernel_size: [3, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
    backbone_no3d:
        down_conv:
            image:
                down_conv:
                    module_name: ResNet18TruncatedLayer4
                view_pooling:
                    module_name: QKVBimodalCSRPool
                    in_mod: 512
                    out_mod: 512
                    num_groups: 4
                    nc_qk: 16
                    use_mod_k: True
                    use_num: True
                drop_mod: 0.2
                interpolate: True
"""

# conf/models/segmentation/sparseconv3d.yaml: the pure-3D file of the same
# name, searched after the multimodal one
SPARSE_3D = """\
Res16UNet14-3D:
    class: sparseconv3d.APIModel
    conv_type: "SPARSE"
    backbone:
        down_conv:
            module_name: ResNetDown
            N: [0, 1, 1, 1, 1]
            down_conv_nn: [[FEAT, 32], [32, 32], [32, 64], [64, 128], [128, 256]]
            kernel_size: [5, 2, 2, 2, 2]
            stride: [1, 2, 2, 2, 2]
"""

# conf/models/segmentation/minkowski_baseline.yaml
MINKOWSKI = """\
MinkUNet14A:
    class: minkowski.Minkowski_Baseline_Model
    conv_type: "SPARSE"
    model_name: "MinkUNet14A"
MinkUNet34C:
    class: minkowski.Minkowski_Baseline_Model
    conv_type: "SPARSE"
    model_name: "MinkUNet34C"
"""

# conf/models/segmentation/multimodal/no3d.yaml
NO3D = """\
RGB_ResNet18PPM_g4_MinMaxDiffSetFeat:
    class: no3d.No3DFeatureFusion
    conv_type: "SPARSE"
    define_constants:
        mod_out: 128
    down_conv:
        image:
            down_conv:
                module_name: ADE20KResNet18PPM
            atomic_pooling:
                mode: max
            view_pooling:
                module_name: GroupBimodalCSRPool
                in_mod: 128
                out_mod: mod_out
                num_groups: 4
                map_encoder: MinMaxDiffSetFeat
            interpolate: True

RGB_UNet-light-logit-drop:
    class: no3d.No3DLogitFusion
    conv_type: "SPARSE"
    define_constants:
        in_feat: 8
        N_CLS: 13
    down_conv:
        image:
            down_conv:
                module_name: ResNetDown
                down_conv_nn:
                    [
                        [4, in_feat],
                        [in_feat, 2*in_feat],
                    ]
                kernel_size: [3, 2]
                stride: [1, 2]
                padding: [1, 0]
                N: [0, 1]
                normalization: GroupNorm
                weight_standardization: True
            up_conv:
                module_name: ResNetUp
                up_conv_nn:
                    [
                        [2*in_feat, in_feat, in_feat],
                    ]
                kernel_size: [2]
                stride: [2]
                N: [1]
            last_conv:
                output_nc: N_CLS
                in_drop: 0.5
                persistent_drop: True
            atomic_pooling:
                mode: max
            view_pooling:
                module_name: BimodalCSRPool
                mode: mean
"""

# conf/data/segmentation/s3disfused.yaml (the Hydra base)
DATA_BASE = """\
# @package data
task: segmentation
class: s3dis.S3DISFusedDataset
dataroot: data
fold: 5
first_subsampling: 0.04
sample_per_epoch: 3000
resolution_2d: [512, 256]
"""

# conf/data/segmentation/multimodal/s3disfused-sparse.yaml
DATA_MM = """\
# @package data
defaults:
    - /data/segmentation/s3disfused

class: s3dis.S3DISFusedDataset
first_subsampling: 0.05
resolution_2d: [64, 32]
exact_splatting_2d: True
min_size_2d: 16

multimodal:
    modality: image
    settings:
        mapping_key: mapping_index
        proj_upscale: 2
        r_max: 8
        r_min: 0.05
        train_pixel_credit: 2
        test_pixel_credit: 3
        k_coverage: 2
        use_bbox: True
    pre_transform:
        - transform: LoadImages
          params:
              ref_size: ${data.resolution_2d}
        - transform: NonStaticMask
          params:
              ref_size: ${data.resolution_2d}
              proj_upscale: ${data.multimodal.settings.proj_upscale}
              n_sample: 5
        - transform: MapImages
          params:
              method: SplattingVisibility
              ref_size: ${data.resolution_2d}
              proj_upscale: ${data.multimodal.settings.proj_upscale}
              voxel: ${data.first_subsampling}
              r_max: ${data.multimodal.settings.r_max}
              r_min: ${data.multimodal.settings.r_min}
              exact: ${data.exact_splatting_2d}
              camera: s3dis_equirectangular
        - transform: NeighborhoodBasedMappingFeatures
          params:
              k: 50
              voxel: ${data.first_subsampling}
              density: True
              occlusion: True
    train_transforms:
        - transform: SelectMappingFromPointId
        - transform: PickImagesFromMappingArea
          params:
              use_bbox: ${data.multimodal.settings.use_bbox}
        - transform: PickImagesFromMemoryCredit
          params:
              img_size: ${data.resolution_2d}
              k_coverage: ${data.multimodal.settings.k_coverage}
              n_img: ${data.multimodal.settings.train_pixel_credit}
        - transform: CenterRoll
          params:
              angular_res: 16
        - transform: CropImageGroups
          params:
              padding: 8
              min_size: ${data.min_size_2d}
        - transform: JitterMappingFeatures
          params:
              sigma: 0.02
              clip: 0.03
        - transform: ColorJitter
          params:
              brightness: 0.6
              contrast: 0.6
              saturation: 0.7
        - transform: RandomHorizontalFlip
        - transform: ToFloatImage

train_transforms:
    - transform: RandomNoise
      params:
          sigma: 0.001
    - transform: RandomRotate
      params:
          degrees: 180
          axis: 2
    - transform: RandomScaleAnisotropic
      params:
          scales: [0.8, 1.2]
    - transform: RandomSymmetry
      params:
          axis: [True, False, False]
    - transform: RandomSphere
      params:
          radius: 1.5
          strategy: RANDOM
"""

FILES = {
    "models/segmentation/multimodal/sparseconv3d.yaml": SPARSE_MM,
    "models/segmentation/multimodal/no3d.yaml": NO3D,
    "models/segmentation/sparseconv3d.yaml": SPARSE_3D,
    "models/segmentation/minkowski_baseline.yaml": MINKOWSKI,
    "data/segmentation/s3disfused.yaml": DATA_BASE,
    "data/segmentation/multimodal/s3disfused-sparse.yaml": DATA_MM,
}


def write_reference_conf(root) -> Path:
    """Writes the tree under ``<root>/conf``; returns that directory (set
    ``DVA_REFERENCE_CONF`` to ``<conf>/models/segmentation`` and
    ``DVA_REFERENCE_DATA_CONF`` to ``<conf>/data/segmentation/multimodal``)."""
    conf = Path(root) / "conf"
    for rel, text in FILES.items():
        path = conf / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return conf
