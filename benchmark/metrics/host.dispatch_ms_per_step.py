"""The host's time in each call of the train step, by the benchmark's own
clock around the call with no synchronize, over the untraced calls of the
window: mean ms a step."""


def read(records):
    d = records.get("dispatch_s") or []
    if not d:
        return None
    return 1e3 * sum(d) / len(d) / records["steps_per_call"]
