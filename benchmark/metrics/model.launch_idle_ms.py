"""Device idle ms a unit while the host enqueues the model's work: inside
the program's spans of the batched forwards and the stitch (a volume of
the denoise entry), or of the train step's forward, backward and AdamW (a
step of the trainer entry). Idle there is the host launching slower than
the device runs."""

from benchmark import spans

SPANS = {
    "denoise": ("inference.forward", "inference.stitch"),
    "trainer": ("trainer.step",),
}


def read(run):
    names = SPANS.get(run.traffic["entry"])
    if names is None:
        return None
    return spans.per_unit_ms(run, spans.idle_seconds_in(run, names))
