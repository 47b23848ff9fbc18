from fast_neural_style_transfer_tpu_torch.data.dataset import ImageFolderDataset
from fast_neural_style_transfer_tpu_torch.data.pipeline import InputPipeline

__all__ = ["ImageFolderDataset", "InputPipeline"]
