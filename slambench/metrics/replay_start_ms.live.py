"""Milliseconds from the host's launch call of a tracking replay to the
graph's first stamp on the card, on one clock (``SlamSystem.trace``): the
median over the window's tracking replays."""

from slambench import program_spans


def read(trace):
    return program_spans.replay_start_ms(trace)
