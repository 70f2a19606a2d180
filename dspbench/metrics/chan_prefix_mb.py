"""MB a call that the F-engine's history concatenation [hist | x] and the
new history's copy read and write (``ops/channelizer.py``
``process_real``), counted by the program from the shapes: its counter
``chan.prefix_bytes`` over ``chan.calls``, in 1e6 bytes.  Every call of a
run has the same shapes, so the mean is each call's count; a program
without the counters gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("chan.calls") or "chan.prefix_bytes" not in c:
        return None
    return c["chan.prefix_bytes"] / c["chan.calls"] / 1e6
