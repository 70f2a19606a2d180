"""Device ms a call of the bank's work beside its kernel: the
[history | x | pad] copies of ``FMReceiverBank.__call__``
(``models/sdr.py``) and the state slices, every device operation of the
call but ``pfb_kernel``."""

from dspbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: "pfb_kernel" not in name)
