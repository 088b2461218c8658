"""Train state and the train / eval steps.

Counterpart of ``exaspim_tpu/train/state.py``: AdamW (optax's ``adamw``:
β = (0.9, 0.999), ε = 1e-8, decoupled weight decay on every parameter, no
mask) with a cosine schedule over the total steps, f32 master params and
bf16 compute inside the model, the loss mean over the batch. A step is
eager PyTorch: forward, ``backward`` (every 3³ conv's dL/dx and dL/dW on
the card's kernels), optimizer update in place. The loss comes back as a
0-dim device tensor, so a caller that does not read it adds no host sync.

The per-step ``augment`` draw of the reference uses ``jax.random`` and
cannot be reproduced bit for bit; ``augment=True`` raises until a later
slice brings its own counter-based draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exaspim_tpu_torch.data.loader import counts_f32
from exaspim_tpu_torch.losses import signal_preserving_loss

__all__ = [
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_cached_train_step",
    "make_eval_step",
    "cosine_schedule",
    "pack_fg_bits",
    "unpack_fg_bits",
    "orient_batch",
]


def cosine_schedule(lr, total_steps, warmup_steps=0):
    """Step → learning rate, with optax's formulas.

    ``warmup_steps == 0``: ``cosine_decay_schedule(lr, total_steps)``,
    ``lr · ½(1 + cos(π · min(t, T) / T))``. Otherwise
    ``warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps)``: a
    linear ramp from 0 over the warmup, then the cosine over the remaining
    ``total_steps − warmup_steps`` (the decay span includes the warmup).
    """
    def cosine(t, peak, span):
        if span <= 0:
            raise ValueError(f"the cosine decay needs positive steps, got {span}")
        t = min(float(t), float(span))
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    if not warmup_steps:
        return lambda t: cosine(t, lr, total_steps)

    def schedule(t):
        if t < warmup_steps:
            return lr * min(max(float(t), 0.0), warmup_steps) / warmup_steps
        return cosine(t - warmup_steps, lr, total_steps - warmup_steps)

    return schedule


class TrainState:
    """The model (its f32 parameters are the state), a
    ``torch.optim.AdamW`` over all of them, the schedule and the step
    count. :meth:`apply_gradients` sets the learning rate for the current
    step, steps the optimizer and clears the gradients."""

    def __init__(self, model, schedule, weight_decay=1e-2):
        self.model = model
        self.schedule = schedule
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.step = 0

    @property
    def params(self):
        return self.model.state_dict()

    def apply_gradients(self):
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def create_train_state(model, lr=1e-3, total_steps=10_000, weight_decay=1e-2,
                       seed=0, warmup_steps=0, params=None):
    """Load a Flax param tree into the model when given, else initialise
    its params (``model.init_weights(seed)``); build the AdamW state."""
    if params is None:
        model.init_weights(seed)
    else:
        from exaspim_tpu_torch.train.checkpoint import params_from_flax

        model.load_state_dict(params_from_flax(params))
    return TrainState(model, cosine_schedule(lr, total_steps, warmup_steps),
                      weight_decay)


def _mask(fg):
    return fg.to(torch.float32) if isinstance(fg, torch.Tensor) else fg


def _update(state, x, y, fg, fg_weight, eps):
    pred = state.model(x)
    loss = signal_preserving_loss(pred, y, _mask(fg), fg_weight=fg_weight,
                                  eps=eps)
    loss.backward()
    state.apply_gradients()
    return state, loss.detach()


def make_train_step(fg_weight=20.0, eps=1e-3, transform=None):
    """The training step ``(state, x, y, fg) -> (state, loss)``.

    With ``transform=None``, ``x``/``y`` are transform-domain
    ``(B, D, H, W, 1)`` f32 tensors. With a frozen transform they are
    count batches (uint16 travels as int16 bits, see
    :func:`exaspim_tpu_torch.data.loader.to_tensor`) and the intensity
    mapping runs on the device inside the step. ``fg`` is a boolean mask.
    """

    def step(state, x, y, fg):
        if transform is not None:
            x = transform.forward(counts_f32(x))
            y = transform.forward(counts_f32(y))
        return _update(state, x, y, fg, fg_weight, eps)

    return step


def pack_fg_bits(fg):
    """Host-side: pack an (N, D, H, W) bool mask to (N, ceil(DHW/8))
    uint8 (np.packbits bit order: MSB-first within each byte)."""
    n = fg.shape[0]
    return np.packbits(
        np.ascontiguousarray(fg, dtype=bool).reshape(n, -1), axis=1
    )


def unpack_fg_bits(packed, patch_shape):
    """Device-side inverse of :func:`pack_fg_bits` for a gathered
    (B, ceil(P/8)) uint8 batch → (B, *patch_shape) bool."""
    nvox = int(np.prod(patch_shape))
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :nvox].reshape(
        packed.shape[0], *patch_shape
    ).bool()


#: the 6 axis permutations of a cubic (B, D, H, W) patch batch
_ORIENT_PERMS = (
    (0, 1, 2, 3), (0, 1, 3, 2), (0, 2, 1, 3),
    (0, 2, 3, 1), (0, 3, 1, 2), (0, 3, 2, 1),
)


def orient_batch(batch, code):
    """Apply one of the 48 cube orientations to a (B, D, D, D) batch:
    ``code % 6`` picks the axis permutation, bit ``a − 1`` of
    ``code // 6`` flips spatial axis ``a``."""
    code = int(code)
    batch = batch.permute(*_ORIENT_PERMS[code % 6])
    for axis in (1, 2, 3):
        if ((code // 6) >> (axis - 1)) & 1:
            batch = batch.flip(axis)
    return batch


def make_cached_train_step(fg_weight=20.0, eps=1e-3, transform=None,
                           preserve_foreground=False, fg_packed=False,
                           augment=False, patch_shape=None):
    """The step over a device-resident cache:
    ``(state, raw_all, teacher_all, fg_all, idx) -> (state, loss)``.

    ``raw_all``/``teacher_all`` are the whole ``(N, D, H, W)`` count cache
    on the device as int16 bit patterns (torch has no uint16 gather);
    ``idx`` is the ``(B,)`` int64 batch slice of the epoch permutation.
    The gather, the ``where(fg, raw, teacher)`` target rule and the
    intensity transform run on the device. ``fg_all`` is None when the
    loss never reads fg (``fg_weight == 0`` and not
    ``preserve_foreground``), else the mask, bit-packed with
    :func:`pack_fg_bits` when ``fg_packed``.
    """
    if augment:
        raise NotImplementedError(
            "augment=True (the per-step orientation draw) comes with a later "
            "slice of the port: the reference draws it with jax.random"
        )
    needs_fg = preserve_foreground or fg_weight != 0

    def step(state, raw_all, teacher_all, fg_all, idx):
        raw = raw_all.index_select(0, idx)
        teacher = teacher_all.index_select(0, idx)
        fg, target = 0.0, teacher  # loss weight identically 1
        if needs_fg:
            if fg_packed:
                shape = patch_shape or tuple(raw_all.shape[1:])
                fg_b = unpack_fg_bits(fg_all.index_select(0, idx), shape)
            else:
                fg_b = fg_all.index_select(0, idx).bool()
            fg = fg_b[..., None]
            if preserve_foreground:
                target = torch.where(fg_b, raw, teacher)
        x = counts_f32(raw)[..., None]
        y = counts_f32(target)[..., None]
        if transform is not None:
            x = transform.forward(x)
            y = transform.forward(y)
        return _update(state, x, y, fg, fg_weight, eps)

    return step


def make_eval_step(fg_weight=20.0, eps=1e-3, transform=None):
    """The eval step ``(state, x, y, fg) -> (loss, pred)`` under
    ``torch.inference_mode()``. With a ``transform`` the inputs are count
    batches and ``pred`` comes back as int32 counts on the device (the
    quantization of ``transform.inverse``), ready for the metrics."""

    def step(state, x, y, fg):
        with torch.inference_mode():
            if transform is not None:
                x = transform.forward(counts_f32(x))
                y = transform.forward(counts_f32(y))
            pred = state.model(x)
            loss = signal_preserving_loss(pred, y, _mask(fg),
                                          fg_weight=fg_weight, eps=eps)
            if transform is not None:
                return loss, transform.inverse_counts(pred)
            return loss, pred

    return step
