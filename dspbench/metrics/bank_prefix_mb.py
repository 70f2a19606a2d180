"""MB a call that the bank's [hist | x | pad] copies read and write
(``models/sdr.py`` ``_flat_prefix``), counted by the program from the
shapes: its counter ``bank.prefix_bytes`` over ``bank.calls``, in 1e6
bytes.  Every call of a run has the same shapes, so the mean is each
call's count; a program without the counters gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("bank.calls") or "bank.prefix_bytes" not in c:
        return None
    return c["bank.prefix_bytes"] / c["bank.calls"] / 1e6
