from fast_neural_style_transfer_tpu_torch.ops.conv import (
    conv2d_same,
    conv_transpose2d,
    max_pool2d,
    reflect_conv2d,
    reflect_pad_hw,
)
from fast_neural_style_transfer_tpu_torch.ops.cuda_conv import (
    Conv2dSameSmallCinFn,
    conv2d_same_bwd,
    conv2d_same_bwd_reference,
    conv2d_same_dx,
    conv2d_same_dx_reference,
)
from fast_neural_style_transfer_tpu_torch.ops.cuda_norm import (
    InstanceNormFn,
    instance_norm_apply_stats,
    instance_norm_apply_stats_reference,
    instance_norm_bwd,
    instance_norm_bwd_reference,
    instance_norm_fwd,
    instance_norm_fwd_reference,
)
from fast_neural_style_transfer_tpu_torch.ops.gram import gram_matrix
from fast_neural_style_transfer_tpu_torch.ops.norm import (
    apply_instance_norm_stats,
    instance_norm,
    instance_norm_stats,
)

__all__ = [
    "Conv2dSameSmallCinFn",
    "InstanceNormFn",
    "apply_instance_norm_stats",
    "conv2d_same",
    "conv2d_same_bwd",
    "conv2d_same_bwd_reference",
    "conv2d_same_dx",
    "conv2d_same_dx_reference",
    "conv_transpose2d",
    "gram_matrix",
    "instance_norm",
    "instance_norm_apply_stats",
    "instance_norm_apply_stats_reference",
    "instance_norm_bwd",
    "instance_norm_bwd_reference",
    "instance_norm_fwd",
    "instance_norm_fwd_reference",
    "instance_norm_stats",
    "max_pool2d",
    "reflect_conv2d",
    "reflect_pad_hw",
]
