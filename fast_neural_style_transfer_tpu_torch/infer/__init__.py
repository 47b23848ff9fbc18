from fast_neural_style_transfer_tpu_torch.infer.spatial import stylize_spatial
from fast_neural_style_transfer_tpu_torch.infer.spatial_adain import stylize_arbitrary_spatial
from fast_neural_style_transfer_tpu_torch.infer.stylize import (
    Stylizer,
    pipeline_directory,
    stylize_directory,
    stylize_image_file,
)

__all__ = [
    "Stylizer",
    "pipeline_directory",
    "stylize_arbitrary_spatial",
    "stylize_directory",
    "stylize_image_file",
    "stylize_spatial",
]
