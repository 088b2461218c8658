"""Device idle ms a volume inside the program's ``rcan.attention`` spans
(3D-RCAN's channel attentions: the pool from the conv's Σy, the two 1×1
maps, the sigmoid, the scale-and-add): the attentions' small launches
starving the device. None for a model without the spans."""

from benchmark import spans


def read(run):
    return spans.per_unit_ms(run,
                             spans.idle_seconds_in(run, ("rcan.attention",)))
