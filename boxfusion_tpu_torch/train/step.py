"""Training step for CuTR (PyTorch): the set loss, autograd, AdamW.

Port of ``boxfusion_tpu/train/step.py``.  The loss is the JAX package's:
the batch mean of the per-image set loss, averaged over every decoder
layer's predictions (deep supervision; the reference refines boxes layer
by layer, cubify_transformer.py:330-349).  The update is optax's
``adamw``, reproduced with ``torch.optim.AdamW``:

  * betas (0.9, 0.999), eps 1e-8 added outside the square root, weight
    decay decoupled and multiplied by the learning rate -- optax's
    defaults, and what torch computes with the same numbers;
  * the learning rate is a schedule evaluated on optax's count: the k-th
    update (from 0) uses ``schedule(k)``;
  * every parameter is updated, as optax updates every leaf: where
    backward leaves ``.grad`` None (the encoder proposals' class head,
    whose logits are not in the loss), the gradient is zero and the
    parameter still decays.  ``torch.optim.AdamW`` skips a parameter whose
    ``.grad`` is None, so the step fills in zeros first.

The parameters live in the model; ``TrainState`` holds the model, its
optimizer and the update count, and ``train_step`` updates them in place.
``parallel/mesh.py:shard_train_step`` runs the same ``train_step`` with the
parameters and moments sharded over a device mesh: it hands the step the
gathered parameters and the share of the loss each data rank takes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

import torch
from torch.func import functional_call

from boxfusion_tpu_torch.models.cutr.model import CubifyTransformer, FrameBatch
from boxfusion_tpu_torch.train.loss import detection_loss

Schedule = Callable[[int], float]

# optax.adamw's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
PRED_KEYS = ("logits", "boxes", "proj_xy", "z_scaled", "dims", "pose")


@dataclasses.dataclass
class TrainState:
    model: CubifyTransformer
    optimizer: torch.optim.Optimizer
    step: int = 0


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to ``end_value``
    at ``decay_steps`` (counted from 0, warmup included), constant after."""

    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        count = int(count)
        if count < warmup_steps:
            return (init_value - peak_value) * (1.0 - count / warmup_steps) + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _as_schedule(learning_rate: Union[float, Schedule]) -> Schedule:
    if callable(learning_rate):
        return learning_rate
    return lambda count: float(learning_rate)


def set_loss(out: Dict, batch: FrameBatch, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean over the batch of the per-image set loss, averaged over the
    decoder layers of ``out`` (the model's output in train mode; JAX
    ``loss_fn``)."""
    S = float(batch.image.shape[1])
    layers = out["intermediates"]
    total = 0.0
    for inter in layers:
        pred = {k: inter[k].float() for k in PRED_KEYS}
        total = total + detection_loss(pred, targets, S)["total"].mean()
    return total / len(layers)


def batch_loss(model: CubifyTransformer, batch: FrameBatch, targets: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """``set_loss`` of the model's train-mode forward."""
    return set_loss(model(batch, train=True), batch, targets)


def apply_update(state: TrainState, schedule: Schedule, loss: torch.Tensor) -> None:
    """Backward through ``loss`` and one AdamW update at ``schedule(step)``;
    a parameter that backward leaves without a gradient gets a zero one.
    The gradients stay in ``.grad`` until the next update."""
    opt = state.optimizer
    lr = float(schedule(state.step))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    state.step += 1


def make_optimizer(params: Iterable[torch.Tensor], weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with optax.adamw's betas, eps and decoupled decay;
    its learning rate is set by ``apply_update`` before every update."""
    return torch.optim.AdamW(params, lr=0.0, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=weight_decay)


def make_train_step(
    model: CubifyTransformer,
    learning_rate: Union[float, Schedule] = 1e-4,
    weight_decay: float = 1e-4,
):
    """Returns (train_step, optimizer).

    ``train_step(state, batch: FrameBatch, targets, params=None,
    loss_scale=1.0) -> (state, metrics)``; targets is a dict of (B, G, ...)
    tensors (see train/loss.py) on the model's device.  ``params``, when
    given, maps parameter names to the tensors the forward uses in place of
    the model's own (``functional_call``; the gradient flows back through
    them; a module registered under two names is one module, so one name
    replaces its parameter on both paths); the update backpropagates ``loss_scale`` times the loss.
    ``metrics["loss"]`` is the unscaled loss, a 0-d tensor on the device
    (read it only when it is needed: the read waits for the step).
    ``train_step.schedule`` is the learning-rate schedule.
    """
    schedule = _as_schedule(learning_rate)
    optimizer = make_optimizer(model.parameters(), weight_decay)

    def train_step(state: TrainState, batch: FrameBatch, targets,
                   params: Optional[Mapping[str, torch.Tensor]] = None, loss_scale: float = 1.0):
        if params is None:
            out = state.model(batch, train=True)
        else:
            out = functional_call(state.model, dict(params), (batch,), {"train": True},
                                  tie_weights=False)
        loss = set_loss(out, batch, targets)
        apply_update(state, schedule, loss * loss_scale)
        return state, {"loss": loss.detach()}

    train_step.schedule = schedule
    return train_step, optimizer


def init_train_state(model: CubifyTransformer, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)
