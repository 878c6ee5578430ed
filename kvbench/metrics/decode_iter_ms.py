"""Decode worker: wall milliseconds a ``DecodeWorker.decode_iteration``
call, total over count in the window (each call ends in its token pull,
a device synchronise)."""


def read(run):
    spans = run.probe.spans.get("decode_iteration", [])
    return sum(spans) / len(spans) * 1e3 if spans else None
