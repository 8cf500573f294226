"""The references' shared training loop and what it reads out.

A reference step function returns the step's loss; this loop takes the
gradients with autograd, applies Adam and the EMA update, and keeps the
three readings that ``correct`` compares: each step's loss, each leaf's
first gradient as the optimizer gets it (with the L2 decay), and each
leaf's change over the steps (the model's parameters, the EMA's, and the
contrast banks).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

import torch

from . import plain

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


class Readings(NamedTuple):
    loss: List[float]
    grad: Dict[str, float]      # leaf -> norm of its first gradient
    change: Dict[str, float]    # leaf -> norm of its change over the steps
    raw: Dict[str, float]       # leaf -> the first gradient without decay


def split_weights(weights: Dict[str, torch.Tensor], device
                  ) -> Tuple[Dict, Dict, Dict]:
    """(model, EMA, others) as fp32 copies on ``device``: the model's
    parameters take gradients, the EMA starts as a copy of the model, and
    ``others`` keeps every tensor outside ``model.``, under its full
    name."""
    W, rest = {}, {}
    for k, v in weights.items():
        if k.startswith("model."):
            name = k[len("model."):]
            t = v.detach().to(device).clone()
            if t.is_floating_point() and not name.endswith(BUFFERS):
                t.requires_grad_(True)
            W[name] = t
        else:
            rest[k] = v.detach().to(device).clone()
    E = {k: v.detach().clone() for k, v in W.items()}
    return W, E, rest


def _params(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in P.items() if v.requires_grad}


def run_steps(cfg: Dict, inp: Dict, W: Dict, E: Dict, extra: Dict,
              feed: Iterator[Dict], step: Callable, n_steps: int,
              quant: str) -> Readings:
    """``n_steps`` of ``step(t, batch, gens, q) -> loss`` over the model
    ``W`` (and the trained tensors of ``extra``, full names), its EMA
    ``E``, and the untrained state of ``extra`` (banks), whose change is
    read too."""
    o = cfg["options"]
    dev = inp["device"]
    s = inp["seeds"]
    plain.no_tf32()
    gens = {"augment": torch.Generator(device=dev).manual_seed(s["augment"]),
            "teacher": torch.Generator(device=dev).manual_seed(s["teacher"])}
    plain.default_generator(dev).manual_seed(s["dropout"])
    q = plain.QUANTS[quant]
    trained = {**{f"model.{k}": v for k, v in _params(W).items()},
               **_params(extra)}
    tracked = {**trained,
               **{f"ema.{k}": v for k, v in E.items() if k in _params(W)},
               **{k: v for k, v in extra.items() if not v.requires_grad}}
    start = {k: v.detach().clone() for k, v in tracked.items()}
    adam = plain.Adam(o["beta1"], o["beta2"], o["weight_decay"])
    steps_per_epoch = inp["n_data"] // o["batch_size"]
    losses = []
    for t in range(n_steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(feed).items()}
        loss = step(t, batch, gens, q)
        names = list(trained)
        grads = torch.autograd.grad(loss, [trained[k] for k in names],
                                    allow_unused=True)
        adam.step(trained, dict(zip(names, grads)),
                  plain.linear_lr(o, t, steps_per_epoch))
        plain.ema_update(E, _params(W), o["ema_decay"], t)
        losses.append(float(loss.detach()))
    grad = {k: float(torch.linalg.vector_norm(g))
            for k, g in adam.first_grads.items()}
    change = {k: float(torch.linalg.vector_norm(v.detach() - start[k]))
              for k, v in tracked.items()}
    raw = {k: float(torch.linalg.vector_norm(g))
           for k, g in adam.first_raw.items()}
    return Readings(losses, grad, change, raw)
