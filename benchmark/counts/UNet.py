"""The 3³ convs of the U-Net denoisers, frozen: a copy of the port's
``ops/nb_bench.unet_conv_shapes`` as it was taken for the benchmark.

``conv_shapes(n, model_config)`` lists the convs of one forward and
backward on an ``n``³ input as ``(kind, n_i, segments, Cout)``: kind
``fwd`` (18) or ``dx`` (17: every conv but the entry conv, whose input
needs no gradient). The encoder halves every stage and the decoder
doubles it, in ``UNet`` and ``N2V2UNet`` alike; the trilinear ups keep
the channels, so each ``Up``'s mid conv halves them.
"""

from __future__ import annotations

BASE = (32, 64, 128, 256, 512)


def channels(width, base=BASE):
    return tuple(int(c * width) for c in base)


def unet_conv_shapes(n, width=1.0, base=BASE, top_skip=True):
    """``top_skip=False`` is N2V2's last ``Up``, which convolves the
    upsampled segment alone."""
    c1, c2, c3, c4, c5 = channels(width, base)
    fwd = []
    for i, (cin, cout) in enumerate(((1, c1), (c1, c2), (c2, c3), (c3, c4),
                                     (c4, c5 // 2))):
        fwd += [(n >> i, (cin,), cout), (n >> i, (cout,), cout)]
    ups = [(c4, c5 // 2, c4 // 2), (c3, c4 // 2, c3 // 2),
           (c2, c3 // 2, c2 // 2), (c1 if top_skip else 0, c2 // 2, c1)]
    for i, (cs, cu, cout) in enumerate(ups):
        m = n >> (3 - i)
        segs = (cs, cu) if cs else (cu,)
        fwd += [(m, segs, (cs + cu) // 2), (m, ((cs + cu) // 2,), cout)]
    out = [("fwd", *f) for f in fwd]
    out += [("dx", m, (cout,), sum(segs)) for m, segs, cout in fwd[1:]]
    return out


def conv_shapes(n, model_config):
    return unet_conv_shapes(
        n, float(model_config.get("width_multiplier", 1.0)),
        tuple(model_config.get("base_channels", BASE)))
