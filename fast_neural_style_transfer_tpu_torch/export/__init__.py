"""Export: the reference ``.pth`` layout, ONNX (stylizer and AdaIN
pipeline, with a minimal runtime), TorchScript, and Hugging Face packaging.

    python -m fast_neural_style_transfer_tpu_torch.export.cli --help
"""

from fast_neural_style_transfer_tpu_torch.export.onnx_export import (
    build_onnx_model,
    export_onnx,
)
from fast_neural_style_transfer_tpu_torch.export.torch_convert import (
    load_torch_checkpoint,
    save_torch_checkpoint,
    save_torch_training_checkpoint,
    to_torch_state_dict,
)

__all__ = [
    "build_onnx_model",
    "export_onnx",
    "load_torch_checkpoint",
    "save_torch_checkpoint",
    "save_torch_training_checkpoint",
    "to_torch_state_dict",
]
