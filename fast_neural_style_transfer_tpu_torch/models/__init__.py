from fast_neural_style_transfer_tpu_torch.models.transformer import (
    NUM_IN_SITES,
    NUM_RES_BLOCKS,
    TransformerNet,
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
    "load_checkpoint",
    "params_from_jax",
    "save_params_npz",
]
