"""Mean host milliseconds of a checkpoint (``save_object``) in the window,
from the benchmark's spans; nothing in a cell whose fits save none."""


def read(run):
    spans = run.spans.get("checkpoint") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
