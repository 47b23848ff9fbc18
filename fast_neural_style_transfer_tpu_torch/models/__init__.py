from fast_neural_style_transfer_tpu_torch.models.transformer import (
    NUM_IN_SITES,
    NUM_RES_BLOCKS,
    TransformerNet,
    bake_style,
    num_styles,
    require_single_style,
)
from fast_neural_style_transfer_tpu_torch.models.vgg import VGG19Features
from fast_neural_style_transfer_tpu_torch.models.weights import (
    load_checkpoint,
    params_from_jax,
    save_params_npz,
)

__all__ = [
    "NUM_IN_SITES",
    "NUM_RES_BLOCKS",
    "TransformerNet",
    "VGG19Features",
    "bake_style",
    "load_checkpoint",
    "num_styles",
    "params_from_jax",
    "require_single_style",
    "save_params_npz",
]
