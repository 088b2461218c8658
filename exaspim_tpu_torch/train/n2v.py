"""Noise2Void self-supervised training (blind-spot masking).

Counterpart of ``exaspim_tpu/train/n2v.py``: train a denoiser from noisy
data alone by replacing random voxels with a neighbour's value and scoring
the prediction only at those sites, so the net cannot learn the identity.

The draw is the reference's, bit for bit: a step keyed by
``fold_in(key(seed), step)`` splits its key, masks where a batch-sized
uniform falls below the rate and draws one nonzero roll per sample.
:mod:`exaspim_tpu_torch.train.prng` computes the mask on the batch's
device in integer arithmetic and the ``(B, 3)`` shifts on the host, so the
same seed and step mask the same voxels in both packages. A key is a pair
of uint32 words (``prng.key(seed)``, ``prng.fold_in(key, step)``).
"""

from __future__ import annotations

import torch

from exaspim_tpu_torch.data.loader import counts_f32
from exaspim_tpu_torch.losses import charbonnier
from exaspim_tpu_torch.train import prng

__all__ = ["make_blind_spots", "make_n2v_train_step"]


def make_blind_spots(key, batch_shape, mask_rate=0.005, max_shift=2,
                     device="cuda"):
    """Blind-spot masks and per-sample neighbour shifts of one step.

    Returns ``(mask, shifts)``: ``mask`` a bool tensor of ``batch_shape``
    on ``device`` (≈ ``mask_rate`` of the voxels set), ``shifts`` a
    ``(B, 3)`` int64 CPU tensor of roll offsets in
    ``[−max_shift, max_shift]``, none all zero (a zero roll would leak the
    centre value; it becomes ``(max_shift,) * 3``).
    """
    kmask, kshift = prng.split(key)
    mask = prng.uniform_below(kmask, batch_shape, mask_rate, device)
    shifts = prng.randint(kshift, (batch_shape[0], 3), -max_shift,
                          max_shift + 1)
    shifts[(shifts == 0).all(axis=1)] = max_shift
    return mask, torch.from_numpy(shifts)


def _substitute(x, mask, shifts):
    """Replace the masked voxels of each ``(D, H, W)`` sample with those of
    a copy rolled by its shift."""
    rolled = torch.stack([
        torch.roll(xi, tuple(s), dims=(0, 1, 2))
        for xi, s in zip(x, shifts.tolist())])
    return torch.where(mask, rolled, x)


def make_n2v_train_step(transform=None, mask_rate=0.005, max_shift=2,
                        eps=1e-3, sigma_gain=None, sigma_read=0.0):
    """The N2V step ``(state, x, key) -> (state, loss)``.

    ``x``: noisy ``(B, D, H, W, 1)`` batches, raw counts with a
    ``transform`` (uint16 travels as int16 bits, see
    :func:`exaspim_tpu_torch.data.loader.to_tensor`), else transform-domain
    floats. ``key``: ``prng.fold_in(prng.key(seed), step)``. The loss is
    the Charbonnier mean over the masked sites.

    ``sigma_gain`` switches on the σ-aware count-space loss: the masked
    residuals are taken in counts (``transform.inverse_float_smooth`` of
    the prediction against the observed counts) and divided by the local
    Poisson–Gaussian scale ``sqrt(gain·c + read² + 1)``, so bright voxels
    weigh as much as the background. It needs a ``transform``.
    """
    if sigma_gain is not None and transform is None:
        raise ValueError(
            "sigma_gain requires a transform: the sigma-aware loss is "
            "computed in count space, so the step must receive raw "
            "counts (not transform-domain floats).")

    def step(state, x, key):
        counts = counts_f32(x)
        if transform is not None:
            x = transform.forward(counts)
        x3 = x[..., 0]
        mask, shifts = make_blind_spots(key, tuple(x3.shape), mask_rate,
                                        max_shift, device=x3.device)
        x_in = _substitute(x3, mask, shifts)[..., None]
        m = mask.to(torch.float32)
        pred = state.model(x_in)[..., 0]
        if sigma_gain is not None:
            c3 = counts[..., 0]
            sigma = torch.sqrt(sigma_gain * torch.clamp(c3, min=0.0)
                               + sigma_read * sigma_read + 1.0)
            err = charbonnier((transform.inverse_float_smooth(pred) - c3)
                              / sigma, eps)
        else:
            err = charbonnier(pred - x3, eps)
        loss = (err * m).sum() / torch.clamp(m.sum(), min=1.0)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step
