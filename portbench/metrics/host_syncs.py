"""host_syncs.train / host_syncs.render: the program's host syncs an
iteration or a chunk: the entries of the spans named host_sync.<site> in
the traced stretch, over its iterations or chunks. None where the program
marks no host sync."""
from portbench.metrics._common import per

PREFIX = "host_sync."


def read(reading, suffix):
    n = per(reading, suffix)
    if n is None:
        return None
    spans = reading["timeline"].spans
    count = sum(len(iv) for name, iv in spans.items() if name.startswith(PREFIX))
    return count / n if count else None
