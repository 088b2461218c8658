"""The benchmark's one input generator: phantom neurite volumes and the
patches cut from them, made on the device from the run's seed.

A traffic file's ``inputs`` holds every parameter; the program receives
only what this module makes. The phantoms follow the port's synthetic
family (randomly oriented tubes over a pedestal, a Gaussian PSF, Poisson
shot noise and Gaussian read noise, ``data/synthetic.py``), drawn here on
the card with one ``torch.Generator`` in a few large calls, so set-up does
not synthesise on the host. Every seed makes the same sizes and counts:
only the values differ.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def sub_seed(seed, *keys):
    """A seed of its own for one part of a run (a rank's share of the
    inputs, the weights), drawn from the run's seed and ``keys``."""
    return int(np.random.SeedSequence([int(seed), *keys]).generate_state(
        1, np.uint64)[0])


def _blur(x, sigma):
    """Separable Gaussian blur (radius ``int(4σ + 0.5)``, edges
    replicated) of a ``(Z, Y, X)`` float tensor, as shifted sums: the same
    bits on every run."""
    r = int(4 * sigma + 0.5)
    t = torch.arange(-r, r + 1, dtype=torch.float64)
    w = torch.exp(-0.5 * (t / sigma) ** 2)
    w = (w / w.sum()).tolist()
    for axis in range(3):
        pad = [0] * 6
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r
        xp = torch.nn.functional.pad(x[None, None], pad, mode="replicate")[0, 0]
        n = x.shape[axis]
        x = sum(wi * xp.narrow(axis, i, n) for i, wi in enumerate(w))
    return x


def clean_block(shape, p, gen, device):
    """One noise-free phantom block and its tube mask (pre-PSF)."""
    tubes = int(p["tubes"])
    u = torch.rand((tubes, 5), generator=gen, device=device,
                   dtype=torch.float64)
    dirs = torch.randn((tubes, 3), generator=gen, device=device,
                       dtype=torch.float64)
    dirs = dirs / (dirs.norm(dim=1, keepdim=True) + 1e-9)
    lo_r, hi_r = p["radius"]
    lo_v, hi_v = p["intensity"]
    ext = torch.tensor(shape, device=device, dtype=torch.float64)
    p0 = u[:, :3] * ext
    radius = lo_r + (hi_r - lo_r) * u[:, 3]
    value = lo_v + (hi_v - lo_v) * u[:, 4]
    axes = [torch.arange(n, device=device, dtype=torch.float32)
            for n in shape]
    zc, yc, xc = (a.reshape(s) for a, s in zip(
        axes, ((-1, 1, 1), (1, -1, 1), (1, 1, -1))))
    clean = torch.zeros(shape, device=device, dtype=torch.float32)
    fg = torch.zeros(shape, device=device, dtype=torch.bool)
    for i in range(tubes):
        c = [float(v) for v in p0[i]]
        d = [float(v) for v in dirs[i]]
        rz, ry, rx = zc - c[0], yc - c[1], xc - c[2]
        along = rz * d[0] + ry * d[1] + rx * d[2]
        tube = rz * rz + ry * ry + rx * rx - along * along \
            <= float(radius[i]) ** 2
        clean += tube * float(value[i])
        fg |= tube
    clean = _blur(clean, float(p["psf_sigma"])) + float(p["background"])
    return clean, fg


def mirror_tile(x, reps):
    """``x`` tiled ``reps`` times along each axis, every other copy
    mirrored, so the seams are continuous."""
    for axis, r in enumerate(reps):
        parts = [x if i % 2 == 0 else x.flip(axis) for i in range(r)]
        x = torch.cat(parts, axis)
    return x


def observe(clean, p, gen):
    """Poisson shot noise at ``gain`` and Gaussian read noise, rounded and
    clipped to uint16 counts (int32 tensor)."""
    gain = float(p.get("gain", 1.0))
    counts = torch.poisson(clean.clamp(min=0) / gain, generator=gen) * gain
    counts += float(p["read_noise"]) * torch.randn(
        clean.shape, generator=gen, device=clean.device)
    return counts.round_().clamp_(0, 65535).to(torch.int32)


def volumes(p, seed, device):
    """``p["count"]`` noisy volumes of ``p["shape"]`` (uint16 numpy): each
    a phantom block of ``p["block"]`` mirror-tiled to the shape, then
    observed with noise at the whole size."""
    gen = generator(seed, device)
    block = tuple(p["block"])
    reps = tuple(s // b for s, b in zip(p["shape"], block))
    out = []
    for _ in range(int(p["count"])):
        clean, _ = clean_block(block, p, gen, device)
        noisy = observe(mirror_tile(clean, reps), p, gen)
        out.append(noisy.cpu().numpy().astype(np.uint16))
    return out


def patches(p, seed, device):
    """``p["count"]`` patches of ``p["patch"]``³ cut at seeded positions
    from ``p["volumes"]`` phantom blocks of ``p["block"]``: raw (noisy)
    counts, the clean phantom rounded to counts and the tube mask, each an
    ``(N, P, P, P)`` device tensor (int32, int32, bool). The blocks are
    observed once, so overlapping patches share their noise."""
    gen = generator(seed, device)
    P = int(p["patch"])
    block = tuple(p["block"])
    n, nv = int(p["count"]), int(p["volumes"])
    per = [n // nv + (i < n % nv) for i in range(nv)]
    raw, clean_c, fg = [], [], []
    for k in range(nv):
        clean, mask = clean_block(block, p, gen, device)
        noisy = observe(clean, p, gen)
        counts = clean.round().clamp(0, 65535).to(torch.int32)
        starts = [torch.randint(0, b - P + 1, (per[k],), generator=gen,
                                device=device).tolist() for b in block]
        for z, y, x in zip(*starts):
            sl = (slice(z, z + P), slice(y, y + P), slice(x, x + P))
            raw.append(noisy[sl])
            clean_c.append(counts[sl])
            fg.append(mask[sl])
    return torch.stack(raw), torch.stack(clean_c), torch.stack(fg)


def draw_indices(seed, n, k):
    """``k`` distinct indices below ``n``, drawn from the seed (the sample
    of finished units that the check compares)."""
    rng = np.random.default_rng([int(seed), 7])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
