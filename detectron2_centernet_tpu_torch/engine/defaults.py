"""Single-image inference from a config (counterpart of the JAX package's
``engine/defaults.py::DefaultPredictor``).

Training, the trainer and its hooks, and evaluation are not ported yet.
"""

from typing import Dict

import numpy as np
import torch

from ..config import CfgNode
from ..data import letterbox_transform, warp_image
from ..models import build_model


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a torch checkpoint whose keys are the reference fork's (a bare
    state dict, or one under "model" or "state_dict"; a DataParallel
    "module." prefix is dropped). Every key must match."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict"):
        if isinstance(data, dict) and wrapper in data:
            data = data[wrapper]
    model.load_state_dict({k.removeprefix("module."): v for k, v in data.items()})


class DefaultPredictor:
    """One image per call, with the config's test transform: BGR/RGB per
    ``INPUT.FORMAT``, the ctdet letterbox warped on the model's device, one
    forward, the decode, and ``{"instances": Instances}`` in the image's own
    pixels. Batches go through ``CenterNet.predict_fn`` directly."""

    def __init__(self, cfg: CfgNode) -> None:
        self.cfg = cfg.clone()
        self.model = build_model(self.cfg)
        self.input_format = cfg.INPUT.FORMAT
        if self.input_format not in ("RGB", "BGR"):
            raise ValueError(f"INPUT.FORMAT must be RGB or BGR, got {self.input_format}")
        if cfg.MODEL.WEIGHTS:
            load_weights(self.model.model, cfg.MODEL.WEIGHTS)
        self._size = tuple(cfg.INPUT.TEST_SIZE)

    def __call__(self, original_image: np.ndarray) -> Dict:
        """original_image: (H, W, C) uint8 in BGR (the cv2 convention)."""
        if self.input_format == "RGB":
            original_image = original_image[:, :, ::-1]
        h, w = original_image.shape[:2]
        m = letterbox_transform(h, w, self._size)
        warped = warp_image(original_image, m, self._size, device=self.model.device)
        dets = self.model.predict_fn(warped.permute(2, 0, 1)[None])
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        return self.model.postprocess(dets, [m], [(h, w)])[0]
