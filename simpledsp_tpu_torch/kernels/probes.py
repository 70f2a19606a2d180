"""The probes' kernels: a scaled copy, a tiled transpose, a small float32
product and a row sum (``csrc/probes.cu``).

They replace the Pallas bodies of the JAX package's ``tools/probe_*.py``
(the probes themselves are ``simpledsp_tpu_torch/tools/``).  Each entry runs
the CUDA kernel on CUDA tensors and its plain PyTorch version on CPU tensors,
and raises on any other device; there is no fallback from a kernel to its
plain version.  Each kernel has a wrapper with a ``launches`` count and a
``library()`` that builds ``csrc/probes.cu`` at first use:

- :func:`scale_copy`: y = scale x (``scale_reference``), with 4-, 8- or
  16-byte vectors, or G blocks that each rewrite one small tile;
- :func:`permute`: y[b, c, r] = scale x[b, r, c] of a strided (B, R, C)
  view, optionally split at C/2 into two planes (``permute_reference``);
  the kernel's tile and instance (16-byte or 4-byte accesses) are
  :func:`permute_plan`'s;
- :func:`contract`: a @ b in IEEE float32, optionally with the shift-in
  epilogue of the frame prefix (``contract_reference``); the kernel's form
  (skinny for N <= 16, else tiled, each K step in a block of its own where
  the tiles cannot fill the card) is :func:`contract_plan`'s.  A row's bits
  depend on N alone, not on M or the card: ``contract(a[:r], b)`` is
  ``contract(a, b)[:r]`` bit for bit;
- :func:`row_sum`: the sum of each row of a (rows, cols) view
  (``row_sum_reference``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing

__all__ = ["scale_reference", "permute_reference", "contract_reference",
           "row_sum_reference", "scale_copy", "permute", "contract", "row_sum",
           "scale_copy_kernel", "permute_kernel", "contract_kernel",
           "row_sum_kernel", "contract_plan", "permute_plan", "PermutePlan"]


# -- plain versions ----------------------------------------------------------

def scale_reference(x: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """y = scale x, one rounded product a value."""
    return x * scale


def permute_reference(x3: torch.Tensor, scale: float = 1.0,
                      split: bool = False
                      ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """y[b, c, r] = scale x3[b, r, c] as a contiguous (B, C, R) tensor; with
    ``split`` the (B, C/2, R) planes of c < C/2 and c >= C/2."""
    y = (x3 * scale).transpose(-1, -2).contiguous()
    if not split:
        return y
    half = y.shape[1] // 2
    return y[:, :half].contiguous(), y[:, half:].contiguous()


def _shift_in(prod: torch.Tensor, sf: torch.Tensor, group: int
              ) -> torch.Tensor:
    """Row j of each group of ``group`` rows takes product row j - 1; row 0
    takes the group's row of ``sf``."""
    m, n = prod.shape
    p3 = prod.reshape(m // group, group, n)
    return torch.cat([sf[:, None, :].to(prod.dtype), p3[:, :-1]],
                     1).reshape(m, n)


def contract_reference(a: torch.Tensor, b: torch.Tensor,
                       sf: Optional[torch.Tensor] = None,
                       group: int = 1) -> torch.Tensor:
    """a (M, K) @ b (K, N) as an einsum in the operands' dtype (IEEE float32
    products for float32); with ``sf`` (M / group, N) the shift-in epilogue
    (:func:`contract`)."""
    with ieee_fp32():
        prod = torch.einsum("mk,kn->mn", a, b)
    return prod if sf is None else _shift_in(prod, sf, group)


def row_sum_reference(x2: torch.Tensor) -> torch.Tensor:
    """The sum of each row of a (rows, cols) tensor, (rows,)."""
    return x2.sum(-1)


# -- the CUDA kernels --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/probes.cu`` built and loaded, its entry points typed."""
    lib = _build.load_library("sdsp_probes", ("probes.cu",))
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    sigs = {
        "sdsp_scale_copy_f32": [ptr, ptr, i64, f32, i32, i32, i32, ptr],
        "sdsp_permute_f32": [ptr] * 3 + [i64] * 6 + [f32] + [i32] * 7
                            + [ptr],
        "sdsp_contract_f32": [ptr] * 3 + [i32] * 3 + [i64] * 4
                             + [ptr, i64, i64, i32, i32, i32, ptr],
        "sdsp_row_sum_f32": [ptr, ptr, i64, i32, i64, i32, ptr],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(what: str, *tensors: torch.Tensor) -> None:
    """Raises ValueError unless every tensor is float32 on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"the CUDA {what} kernel takes float32 on one "
                             f"CUDA device, got {t.dtype} on {t.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class _ProbeKernel:
    """One kernel of ``csrc/probes.cu``, built at first launch;
    ``launches`` counts its launches."""

    launches = tracing.Launches()

    def __init__(self, name: str):
        self.name = name
        self.launch_counter = tracing.kernel_counter(name)

    def library(self) -> ctypes.CDLL:
        return _library()

    def _launched(self, rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1


class _ScaleCopyKernel(_ProbeKernel):
    def __call__(self, x: torch.Tensor, scale: float, vec_bytes: int,
                 same_tile_blocks: int) -> torch.Tensor:
        _check(self.name, x)
        x = x.contiguous()
        y = torch.empty_like(x)
        if x.data_ptr() % vec_bytes or y.data_ptr() % vec_bytes:
            raise ValueError(f"{vec_bytes}-byte vectors need {vec_bytes}-byte "
                             f"aligned tensors")
        rc = self.library().sdsp_scale_copy_f32(
            x.data_ptr(), y.data_ptr(), x.numel(), float(scale), vec_bytes,
            same_tile_blocks, x.device.index, _stream(x))
        self._launched(rc)
        return y


class _PermuteKernel(_ProbeKernel):
    def __init__(self, name: str):
        super().__init__(name)
        self.last_plan: Optional[PermutePlan] = None

    def __call__(self, x3: torch.Tensor, scale: float, split: bool,
                 rows_per_block: int, batch_per_block: int):
        _check(self.name, x3)
        nb, nr, nc = x3.shape
        shape = (nb, nc // 2, nr) if split else (nb, nc, nr)
        y0 = torch.empty(shape, dtype=x3.dtype, device=x3.device)
        y1 = torch.empty_like(y0) if split else None
        # y0 and y1 are fresh allocations, which start 16-byte aligned
        plan = permute_plan(x3.shape, x3.stride(),
                            x3.data_ptr() % 16 == 0)
        rc = self.library().sdsp_permute_f32(
            x3.data_ptr(), y0.data_ptr(), None if y1 is None else y1.data_ptr(),
            nb, nr, nc, *x3.stride(), float(scale), rows_per_block,
            batch_per_block, plan.tr, plan.tc, plan.tb, int(plan.vec),
            x3.device.index, _stream(x3))
        self._launched(rc)
        self.last_plan = plan
        return (y0, y1) if split else y0


# The transpose's tiles (csrc/probes.cu): a block of PERMUTE_THREADS threads
# moves a tile of TB batch entries x TR rows x TC columns, PERMUTE_TILE
# floats (the kernel's kPermTile), each side a power of two: TC is C
# rounded up, from PERMUTE_MIN_SIDE to PERMUTE_MAX_TC; TR is R rounded up,
# from PERMUTE_MIN_SIDE to what TC leaves; TB what both leave.  Two tiles a
# block (the next in flight) in shared memory.
PERMUTE_THREADS = 256
PERMUTE_TILE = 8192
PERMUTE_MIN_SIDE, PERMUTE_MAX_TC = 16, 128


class PermutePlan(NamedTuple):
    """The transpose kernel's instance and tile: ``vec`` 16-byte copies and
    stores (else 4-byte), a tile of ``tb`` x ``tr`` x ``tc``."""
    vec: bool
    tr: int
    tc: int
    tb: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def permute_plan(shape: Sequence[int], strides: Sequence[int],
                 aligned: bool) -> PermutePlan:
    """The transpose kernel's plan for a (B, R, C) view of ``strides``
    (elements) whose input and outputs are 16-byte ``aligned``, with tiles
    of PERMUTE_TILE floats.  The 16-byte instance needs contiguous columns,
    C and R multiples of 4 and the row and batch strides too, so that every
    16-byte slot of a tile starts 16-byte aligned in the input and in the
    output; any other view takes 4-byte accesses, the same tiles."""
    return _plan(tuple(shape), tuple(strides), bool(aligned), PERMUTE_TILE)


@functools.lru_cache(maxsize=256)
def _plan(shape: Tuple[int, int, int], strides: Tuple[int, int, int],
          aligned: bool, tile: int) -> PermutePlan:
    nb, nr, nc = shape
    sb, sr, sc = strides
    tc = min(max(_pow2_at_least(nc), PERMUTE_MIN_SIDE), PERMUTE_MAX_TC)
    tr = min(max(_pow2_at_least(nr), PERMUTE_MIN_SIDE), tile // tc)
    vec = (aligned and sc == 1 and nc % 4 == 0 and nr % 4 == 0
           and sr % 4 == 0 and (nb <= 1 or sb % 4 == 0))
    return PermutePlan(bool(vec), tr, tc, tile // (tr * tc))


# The contraction's forms (csrc/probes.cu): N <= SKINNY_MAX_N takes the
# skinny form, a wider N the tiled form's TILE_M x TILE_N tiles of C, whose
# K_STEP-deep steps each take a block of their own, a tile's blocks a
# cluster of at most MAX_SPLIT_STEPS, where the tiles cannot fill the card.
# A staged row of A takes A_PITCH floats in shared memory, of B (tiled
# form) B_PITCH.
SKINNY_MAX_N = 16
TILE_M, TILE_N = 64, 64
K_STEP = 32
MAX_SPLIT_STEPS = 16
A_PITCH, B_PITCH = K_STEP + 4, TILE_N + 4


def contract_plan(m: int, n: int, k: int, sms: int) -> Tuple[str, int]:
    """The contraction kernel's form for an (m, k) x (k, n) product on a
    card of ``sms`` SMs, and the blocks a tile of C's K steps take:
    ("skinny", 1) for n <= 16; else ("tiled", s): s = the K steps, one a
    block, a tile's s blocks a cluster, where fewer tiles than SMs leave the
    card idle and there are 2 to MAX_SPLIT_STEPS steps, else 1.  The form
    and s change the time, never the bits, which depend on n alone."""
    if n <= SKINNY_MAX_N:
        return "skinny", 1
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    steps = -(-k // K_STEP)
    if tiles >= sms or not 2 <= steps <= MAX_SPLIT_STEPS:
        return "tiled", 1
    return "tiled", steps


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _ContractKernel(_ProbeKernel):
    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 sf: Optional[torch.Tensor], group: int) -> torch.Tensor:
        _check(self.name, a, b, *(() if sf is None else (sf,)))
        m, k = a.shape
        n = b.shape[1]
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        ss = (0, 0) if sf is None else sf.stride()
        _, splits = contract_plan(m, n, k, _sm_count(a.device.index))
        rc = self.library().sdsp_contract_f32(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, *a.stride(),
            *b.stride(), None if sf is None else sf.data_ptr(), *ss, group,
            int(splits > 1), a.device.index, _stream(a))
        self._launched(rc)
        return c


class _RowSumKernel(_ProbeKernel):
    def __call__(self, x2: torch.Tensor) -> torch.Tensor:
        _check(self.name, x2)
        rows, cols = x2.shape
        if cols > 1 and x2.stride(1) != 1:
            x2 = x2.contiguous()
        y = torch.empty(rows, dtype=x2.dtype, device=x2.device)
        rc = self.library().sdsp_row_sum_f32(
            x2.data_ptr(), y.data_ptr(), rows, cols, x2.stride(0),
            x2.device.index, _stream(x2))
        self._launched(rc)
        return y


scale_copy_kernel = _ScaleCopyKernel("scale_copy")
permute_kernel = _PermuteKernel("permute")
contract_kernel = _ContractKernel("contract")
row_sum_kernel = _RowSumKernel("row_sum")


def _on_device(x: torch.Tensor, kernel, reference):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return kernel()
    if x.device.type == "cpu":
        return reference()
    raise ValueError(f"the probes' kernels run on CUDA or CPU tensors, got "
                     f"{x.device}")


# -- entries -----------------------------------------------------------------

def scale_copy(x: torch.Tensor, scale: float = 2.0, *, vec_bytes: int = 16,
               same_tile_blocks: int = 0) -> torch.Tensor:
    """y = scale x.  On the card: ``vec_bytes`` (4, 8 or 16) loads and
    stores; ``same_tile_blocks`` = G > 0 launches G blocks that each rewrite
    all of x (a small tile), as the TPU probe's grid of G steps on one
    block did."""
    if vec_bytes not in (4, 8, 16):
        raise ValueError(f"vec_bytes is 4, 8 or 16, got {vec_bytes}")
    if same_tile_blocks < 0:
        raise ValueError(f"same_tile_blocks must be >= 0, got "
                         f"{same_tile_blocks}")
    return _on_device(
        x, lambda: scale_copy_kernel(x, scale, vec_bytes, same_tile_blocks),
        lambda: scale_reference(x, scale))


def permute(x3: torch.Tensor, scale: float = 1.0, *, split: bool = False,
            rows_per_block: int = 32, batch_per_block: int = 1):
    """y[b, c, r] = scale x3[b, r, c] for a (B, R, C) view of any strides:
    a contiguous (B, C, R) tensor, or with ``split`` the (B, C/2, R) planes
    of c < C/2 and c >= C/2.  On the card ``rows_per_block`` rows (a
    multiple of 32) of ``batch_per_block`` batch entries are a unit of
    work, the JAX probe's block: the kernel's blocks take its tiles in
    turn, a unit after the other (``permute_plan`` gives the tiles)."""
    if x3.dim() != 3:
        raise ValueError(f"permute takes a (B, R, C) view, got "
                         f"{tuple(x3.shape)}")
    if rows_per_block < 32 or rows_per_block % 32 or batch_per_block < 1:
        raise ValueError(f"rows_per_block is a positive multiple of 32 and "
                         f"batch_per_block >= 1, got {rows_per_block}, "
                         f"{batch_per_block}")
    if split and x3.shape[2] % 2:
        raise ValueError(f"split needs an even C, got {x3.shape[2]}")
    return _on_device(
        x3, lambda: permute_kernel(x3, scale, split, rows_per_block,
                                   batch_per_block),
        lambda: permute_reference(x3, scale, split))


def contract(a: torch.Tensor, b: torch.Tensor, *,
             sf: Optional[torch.Tensor] = None, group: int = 1
             ) -> torch.Tensor:
    """a (M, K) @ b (K, N) in IEEE float32 (any strides).  With ``sf``
    (M / group, N): row j of each group of ``group`` output rows takes
    product row j - 1 and row 0 takes the group's row of sf (the frame
    prefix's shift, ``concat(sf[:, None], kx[:, :-1])``)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contract takes (M, K) and (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if sf is not None and (group < 1 or a.shape[0] % group
                           or tuple(sf.shape) != (a.shape[0] // group,
                                                  b.shape[1])):
        raise ValueError(f"the shift-in needs M a multiple of group and sf "
                         f"of (M / group, N), got M = {a.shape[0]}, group = "
                         f"{group}, sf {tuple(sf.shape)}")
    return _on_device(a, lambda: contract_kernel(a, b, sf, group),
                      lambda: contract_reference(a, b, sf, group))


def row_sum(x2: torch.Tensor) -> torch.Tensor:
    """The sum of each row of a (rows, cols) view, (rows,)."""
    if x2.dim() != 2:
        raise ValueError(f"row_sum takes (rows, cols), got {tuple(x2.shape)}")
    return _on_device(x2, lambda: row_sum_kernel(x2),
                      lambda: row_sum_reference(x2))
