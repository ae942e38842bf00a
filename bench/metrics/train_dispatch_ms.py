"""The trainer's host loop: the mean host ms of its `dispatch` span (the
step's launches, `train/trainer.py`) a step, from the traced window."""


def read(ctx):
    spans = ctx["trace"].spans.get("dispatch")
    return None if not spans else 1e3 * sum(spans) / len(spans)
