"""The serve cells' system under test: ``serve.make_infer_fn`` over a model
from ``define_model`` with the run's weights, as ``cli/test_cv_MT.py``
(``mode pathomic``: the multimodal teacher) and ``cli/test_cv_path.py``
(``mode path``: the path-only student) evaluate folds."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.serve.export import make_infer_fn


class ServeProgram:
    def __init__(self, mode: str, opt, device):
        gen = torch.Generator().manual_seed(0)
        if mode == "path":
            self.model = define_model(opt, path_only=True, generator=gen)
            opt = opt.replace(mode="path")
        elif mode == "pathomic":
            self.model = define_model(opt, generator=gen)
        else:
            raise ValueError(f"unknown serving mode {mode!r}")
        self.model.to(device).eval()
        self.infer = make_infer_fn(opt, self.model)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f"model.{k}": v for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        for name, t in self.tensors().items():
            t.copy_(weights[name])

    def __call__(self, x_path: np.ndarray, x_omic: np.ndarray
                 ) -> Dict[str, torch.Tensor]:
        return self.infer(x_path, x_omic)

    def close(self) -> None:
        self.model = self.infer = None
