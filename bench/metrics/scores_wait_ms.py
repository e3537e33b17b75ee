"""Mean host time a tick that `FingerService.scores` waited for the last
tick's work to end on the card, before its copy (span
``finger.scores.wait``), in ms."""
from bench import program_spans


def read(rec):
    return program_spans.mean_ms(rec.trace, "finger.scores.wait")
