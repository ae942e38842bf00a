"""The trainer's batch fetch: the mean host ms of the program's `load`
span a step (`train/trainer.py`: from the loader's batch request to the
batch on the device; inside it the loader's `permute` and `gather` spans
and the copy's `h2d`), from the traced window."""


def read(ctx):
    spans = ctx["trace"].spans.get("load")
    return None if not spans else 1e3 * sum(spans) / len(spans)
