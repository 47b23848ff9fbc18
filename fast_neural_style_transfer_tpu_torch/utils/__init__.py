from fast_neural_style_transfer_tpu_torch.utils.color import luminance_transfer, match_color
from fast_neural_style_transfer_tpu_torch.utils.image_io import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    decode_image,
    denormalize_image,
    load_image,
    network_to_u8,
    normalize_image,
    resize_image,
    save_image,
    u8_to_network,
)
from fast_neural_style_transfer_tpu_torch.utils.ssim import ssim, ssim_files

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "decode_image",
    "denormalize_image",
    "load_image",
    "luminance_transfer",
    "match_color",
    "network_to_u8",
    "normalize_image",
    "resize_image",
    "save_image",
    "ssim",
    "ssim_files",
    "u8_to_network",
]
