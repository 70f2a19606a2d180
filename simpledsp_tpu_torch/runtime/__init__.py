"""Native host-side streaming runtime (C++ via ctypes)."""

from simpledsp_tpu_torch.runtime.stream import (
    FileSink,
    FileSource,
    RingBuffer,
    f32_to_i16,
    i16_to_f32,
    iq16_to_planes,
    iqu8_to_planes,
    load_library,
)

__all__ = ["FileSink", "FileSource", "RingBuffer", "f32_to_i16", "i16_to_f32",
           "iq16_to_planes", "iqu8_to_planes", "load_library"]
