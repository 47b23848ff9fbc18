"""Hugging Face Hub packaging and upload (the JAX package's
``export/hf.py``).

- ``package_for_hub``: a repo directory for a stylizer: ``pytorch_model.pth``
  (the reference ``StyleTransferNet`` state_dict), ``params.npz`` (the JAX
  package's params file, which both packages load), ``model.onnx``, a model
  card ``README.md`` and ``config.json``;
- ``package_adain_for_hub``: the same for an AdaIN decoder (``decoder.pth``,
  ``decoder.npz``, the two-input ``adain_pipeline.onnx``);
- ``upload_to_hub``: pushes a directory with ``huggingface_hub`` (imported
  when called; it needs the network and a token).
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import torch

from fast_neural_style_transfer_tpu_torch.export.onnx_export import export_onnx
from fast_neural_style_transfer_tpu_torch.export.torch_convert import to_torch_state_dict
from fast_neural_style_transfer_tpu_torch.models.weights import save_params_npz

_CARD = """---
library_name: fast_neural_style_transfer_tpu_torch
tags: [style-transfer, pytorch, cuda, h100]
---

# Fast Neural Style Transfer

Johnson et al. 2016 feed-forward stylizer with instance normalization,
packaged by fast_neural_style_transfer_tpu_torch, the PyTorch/CUDA port
whose instance norm runs on hand-written Hopper (H100) kernels.

Files:
- `pytorch_model.pth` — PyTorch state_dict (reference `StyleTransferNet` layout)
- `params.npz` — the JAX package's parameter file (both packages load it)
- `model.onnx` — opset-11 ONNX graph (`input_image` -> `output_image`)
- `config.json` — the architecture and the export's settings
"""

_ADAIN_CARD = """---
library_name: fast_neural_style_transfer_tpu_torch
tags: [style-transfer, adain, arbitrary-style, pytorch, cuda, h100]
---

# AdaIN Arbitrary-Style Transfer Decoder

Huang & Belongie 2017 AdaIN decoder (canonical architecture), packaged by
fast_neural_style_transfer_tpu_torch, the PyTorch/CUDA port whose AdaIN
runs on a hand-written Hopper (H100) instance-norm kernel. Stylizes with
any style image; pair it with the torchvision VGG19 encoder weights.

Files:
- `decoder.pth` — PyTorch state_dict (loads into the public
  implementations' decoder Sequential)
- `decoder.npz` — the JAX package's decoder file (both packages load it)
- `adain_pipeline.onnx` — the two-input pipeline (VGG walk + AdaIN +
  decoder) as one opset-11 graph
- `config.json` — the architecture and the export's settings
"""


def _write_card(out_dir: str, card: str, config: dict) -> None:
    with open(os.path.join(out_dir, "README.md"), "w") as fh:
        fh.write(card)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)


def package_for_hub(state_dict, out_dir: str, *,
                    metadata: Optional[dict] = None) -> str:
    """Write a complete stylizer repo directory (a single-style state_dict;
    ``bake_style`` a multi-style one first). ``metadata`` joins
    ``config.json``."""
    sd = to_torch_state_dict(state_dict)
    os.makedirs(out_dir, exist_ok=True)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save(tensors, os.path.join(out_dir, "pytorch_model.pth"))
    save_params_npz(tensors, os.path.join(out_dir, "params.npz"))
    export_onnx(tensors, os.path.join(out_dir, "model.onnx"))
    _write_card(out_dir, _CARD, {"architecture": "TransformerNet", "num_styles": 1,
                                 "input": "NCHW float32, ImageNet-normalized",
                                 **(metadata or {})})
    return out_dir


def package_adain_for_hub(decoder_sd: Mapping[str, Any], vgg_sd: Mapping[str, Any],
                          out_dir: str, *, metadata: Optional[dict] = None) -> str:
    """The AdaIN counterpart of ``package_for_hub``."""
    from fast_neural_style_transfer_tpu_torch.export.onnx_adain import export_adain_onnx
    from fast_neural_style_transfer_tpu_torch.export.torch_adain import (
        save_torch_adain_decoder,
    )
    from fast_neural_style_transfer_tpu_torch.models.adain import save_decoder_npz

    os.makedirs(out_dir, exist_ok=True)
    save_torch_adain_decoder(decoder_sd, os.path.join(out_dir, "decoder.pth"))
    save_decoder_npz(decoder_sd, os.path.join(out_dir, "decoder.npz"))
    export_adain_onnx(decoder_sd, vgg_sd, os.path.join(out_dir, "adain_pipeline.onnx"),
                      content_shape=(1, 3, "height", "width"),
                      style_shape=(1, 3, "style_h", "style_w"))
    _write_card(out_dir, _ADAIN_CARD, {"architecture": "AdaINDecoder",
                                       "encoder": "VGG19 to relu4_1",
                                       "input": "NCHW float32, ImageNet-normalized",
                                       **(metadata or {})})
    return out_dir


def upload_to_hub(local_dir: str, repo_id: str, *, token: Optional[str] = None) -> str:
    """Push a packaged directory to the Hub (needs the network and a token)."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError("upload_to_hub needs the huggingface_hub package") from e
    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=local_dir, repo_id=repo_id)
    return f"https://huggingface.co/{repo_id}"
