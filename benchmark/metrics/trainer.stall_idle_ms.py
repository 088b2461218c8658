"""Device idle ms a step while the trainer's host is off the step: inside
the program's spans of the wait on the loader, the batch's pinned upload
and the log step's drain and write (each instant counted once)."""

from benchmark import spans

STALLS = ("loader.wait", "loader.upload", "trainer.log")


def read(run):
    return spans.per_unit_ms(run, spans.idle_seconds_in(run, STALLS))
