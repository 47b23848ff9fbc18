"""Image-folder dataset (the JAX package's ``data/dataset.py``): a sorted
recursive scan of .png/.jpg/.jpeg files, RGB decode and a bilinear resize to
the training size, uint8 (h, w, 3) out. A file that fails to decode is
replaced by another picked with ``random.Random(f"{seed}:{idx}")``, so the
substitute does not depend on thread scheduling; 16 failures in a row
raise.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

from fast_neural_style_transfer_tpu_torch.utils.image_io import (
    IMAGE_EXTENSIONS,
    decode_image,
    resize_image,
    scan_image_files,
)


class ImageFolderDataset:
    def __init__(self, root: str, image_size: Tuple[int, int] = (256, 256),
                 seed: int = 0):
        self.root = root
        self.image_size = tuple(image_size)
        self.files = scan_image_files(root)
        self.seed = seed
        if not self.files:
            raise FileNotFoundError(
                f"no images ({'/'.join(IMAGE_EXTENSIONS)}) under {root}")
        print(f"dataset: {len(self.files)} images under {root}", flush=True)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        sub_rng = None
        for _ in range(16):
            try:
                return resize_image(decode_image(self.files[idx]), self.image_size)
            except (OSError, ValueError) as e:  # corrupt file: substitute another
                print(f"decode failed for {self.files[idx]}: {e}; substituting",
                      flush=True)
                if sub_rng is None:
                    sub_rng = random.Random(f"{self.seed}:{idx}")
                idx = sub_rng.randrange(len(self.files))
        raise RuntimeError("16 consecutive image decode failures — dataset unusable")
