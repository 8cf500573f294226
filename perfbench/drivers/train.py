"""The train cells' system under test: the port's fold loop, taken apart.

What ``train.loop.train_teacher`` and ``train.student_clat.
train_clat_student`` build for a fold (the dataset with its contrast
sampler, the ``Loader`` on ``host_workers`` threads behind a
``PrefetchLoader`` of ``prefetch_depth``, the model from
``define_model``, the state from ``init_teacher_state`` or
``init_student_state``, the step from ``build_teacher_train_step`` or
``build_clat_student_step``), with the run's weights loaded into it.
Epochs follow each other as in the fold loop, a new ``PrefetchLoader``
pass over a reshuffled epoch each time.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from multimodal_learning_tpu_torch.data.pipeline import (Loader,
                                                         PathomicDataset,
                                                         PrefetchLoader)
from multimodal_learning_tpu_torch.eval.metrics import one_hot
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.steps import (
    build_teacher_train_step, init_teacher_state)
from multimodal_learning_tpu_torch.train.student import (
    freeze_teacher, init_student_state)
from multimodal_learning_tpu_torch.train.student_clat import (
    build_clat_student_step)


def _named(module: torch.nn.Module, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}{k}": v for k, v in module.state_dict().items()}


class TrainProgram:
    """One fold's train path on ``device``.  ``kind`` is ``teacher`` (the
    mean-teacher multimodal step) or ``clat_student`` (the CLAT stage-2
    student under a frozen multimodal teacher)."""

    def __init__(self, kind: str, opt, rois: np.ndarray,
                 tab: Dict[str, np.ndarray], loader_seed: int, device):
        self.kind, self.opt, self.device = kind, opt, torch.device(device)
        n = len(rois)
        data = {"train": {"x_path": list(rois), **tab}}
        contrast = opt.CRD_distill == 1 or opt.distill in ("crd", "hkd")
        self.dataset = PathomicDataset(opt, data, "train", train=True,
                                       contrast=contrast)
        self.loader = Loader(self.dataset, opt.batch_size, shuffle=True,
                             drop_last=True, n_views=2,
                             workers=opt.host_workers, seed=loader_seed)
        schedule = make_lr_schedule(opt, len(self.loader))
        gen = torch.Generator().manual_seed(0)
        if kind == "teacher":
            self.state = init_teacher_state(opt, define_model(
                opt, generator=gen), schedule, n, device=self.device)
            self.step_fn = build_teacher_train_step(opt)
            self.teacher = None
        elif kind == "clat_student":
            self.teacher = freeze_teacher(define_model(opt, generator=gen),
                                          self.device)
            self.state = init_student_state(opt, define_model(
                opt, path_only=True, generator=gen), schedule, n,
                device=self.device)
            class_mask = torch.from_numpy(one_hot(
                self.dataset.g, opt.label_dim).T).to(self.device)
            self.step_fn = build_clat_student_step(opt, self.teacher,
                                                   class_mask)
        else:
            raise ValueError(f"unknown train program {kind!r}")
        self._epochs = self._batches()

    # --- what the benchmark hands in and reads out ----------------------

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor the run's weights set, by the names the reference
        reads: ``model.``, ``ema.``, ``embeds.``, ``teacher.``, and the
        banks' ``bank.<name>.memory_v1|memory_v2``."""
        st = self.state
        out = {**_named(st.model, "model."), **_named(st.ema_model, "ema."),
               **_named(st.embeds, "embeds.")}
        if self.teacher is not None:
            out.update(_named(self.teacher, "teacher."))
        for name, bank in st.banks.items():
            out[f"bank.{name}.memory_v1"] = bank.memory_v1
            out[f"bank.{name}.memory_v2"] = bank.memory_v2
        return out

    @torch.no_grad()
    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        """The run's weights into the model, its EMA (a copy of the
        model's), the heads, the teacher and the banks."""
        for name, t in self.tensors().items():
            src = weights["model." + name[4:]] if name.startswith("ema.") \
                else weights[name]
            t.copy_(src)

    def seed(self, seeds: Dict[str, int]) -> None:
        """The step's generators: augmentation and Kronecker masks, the
        frozen teacher's masks, and the device's default generator
        (nn.Dropout's)."""
        self.state.generator.manual_seed(seeds["augment"])
        if self.state.teacher_generator is not None:
            self.state.teacher_generator.manual_seed(seeds["teacher"])
        if self.device.type == "cuda":
            torch.cuda.default_generators[
                self.device.index or 0].manual_seed(seeds["dropout"])
        else:
            torch.default_generator.manual_seed(seeds["dropout"])

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The state whose change ``correct`` compares: the trained
        parameters (model and heads), the EMA's, and the banks."""
        st = self.state
        out = {f"model.{k}": p for k, p in st.model.named_parameters()}
        out.update({f"embeds.{k}": p
                    for k, p in st.embeds.named_parameters()})
        out.update({f"ema.{k}": p for k, p in st.ema_model.named_parameters()})
        for name, bank in st.banks.items():
            out[f"bank.{name}.memory_v1"] = bank.memory_v1
            out[f"bank.{name}.memory_v2"] = bank.memory_v2
        return out

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """After one Adam update: each trained leaf's gradient as the
        optimizer took it, ``exp_avg / (1 - beta1)``."""
        st = self.state
        adam = st.optimizer.optimizer
        b1 = adam.param_groups[0]["betas"][0]
        named = {f"model.{k}": p for k, p in st.model.named_parameters()}
        named.update({f"embeds.{k}": p
                      for k, p in st.embeds.named_parameters()})
        return {k: adam.state[p]["exp_avg"] / (1.0 - b1)
                for k, p in named.items()}

    # --- the loop ------------------------------------------------------

    def _batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield from PrefetchLoader(self.loader,
                                      depth=self.opt.prefetch_depth,
                                      device=self.device)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        return next(self._epochs)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        opt = self.opt
        if self.kind == "teacher":
            _, metrics = self.step_fn(self.state, batch, opt.CRD_weight)
        else:
            # reweighting from epoch ``start_reweight`` on; the window
            # trains the first epochs
            _, metrics = self.step_fn(self.state, batch,
                                      1 >= opt.start_reweight)
        return metrics

    def close(self) -> None:
        self._epochs.close()
        self.loader.close()
        self.state = self.teacher = self.step_fn = None
