"""Mean requests a dispatched batch (each answer's ``_Pending.batched``)."""


def read(view):
    return view["counters"].get("batch_fill")
