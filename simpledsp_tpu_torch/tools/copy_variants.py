"""Time the probes' copy and transpose kernels (``kernels.probes.scale_copy``
and ``permute``) on the card: ``csrc/probes.cu`` of this checkout and of
other checkouts unpacked beside it (``--roots``), in turns in one call, and
variants of this checkout, each a one-line edit built apart:

- "all": the source as it is;
- "bulk": the 16-byte copy as candidate (b), persistent blocks moving
  16 KB chunks by TMA bulk copies through a ring of four stages (the edit
  adds that kernel, ``_BULK_KERNEL``; as it is: candidate (a), a one-shot
  grid of 16-byte loads and stores);
- "nohint": the copy's loads and stores without their cache hints (as it
  is: loads kept out of L1 and first out of L2, streaming stores);
- "bytes32" / "bytes64": 32 / 64 bytes a copy thread, two / four 16-byte
  vectors (as it is: 16, one 16-byte vector, two 8-byte or four 4-byte);
- "t128" / "t512" / "t1024": copy blocks of 128 / 512 / 1024 threads (as
  it is: 256);
- "nopolicy": the 16-byte loads without their L2 evict-first policy (kept
  out of L1 still); "wbstore": the stores without their streaming hint;
- "single": the transpose with one tile in shared memory, the next tile's
  copies issued after the stores (as it is: a double buffer);
- "tile4k" / "tile16k": transpose tiles of 4096 / 16384 floats (as it is:
  8192: the kernel's kPermTile, and ``kernels/probes.py`` PERMUTE_TILE, set
  in the arm's process); "single16k" both.

Each (checkout, variant) is timed in a process of its own (the checkout's
package first on ``sys.path``) at every case of the probes, as CUDA-graph
replays of 20 calls (device time, ms a call), beside the PyTorch calls of
the same function: ``torch.mul`` and ``y.copy_(x)`` (the card's own
device-to-device copy) at the copies, ``.transpose(-1, -2).contiguous()``
or ``.permute(1, 2, 0).contiguous()`` at the transposes.  Every output is
held to its plain version bit for bit.  The contraction and the row sum
(``csrc/probes.cu`` too) are timed at the probe's sizes, and their bits
must agree across every arm.  The turns run the arms forward, then
backward.  ``bytes`` gives each case's reads and writes, for its bound.
At the 16-byte copies each arm also alternates the kernel, ``torch.mul``
and ``y.copy_(x)`` over ROUNDS rounds (one graph replay of 20 calls each a
round, the order reversed every other round); ``pairs`` counts the rounds
in which the kernel beat each PyTorch call, with the spread of each.

``--trace`` adds, from one ``torch.profiler`` session in the parent process
(this checkout), each device activity of the copy, ``torch.mul`` and
``y.copy_(x)`` at f = 16384: its name, kind, grid, block and µs.

    python3 simpledsp_tpu_torch/tools/copy_variants.py [--roots DIR ...] [--variants all bulk ...] [--turns 2] [--trace]

Prints one JSON object with each turn's numbers and their summary
{"root@variant": {case: [ms, ...]}}, also written to
``chiprun_out/copy_variants.json``; raises without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
F = 16384
NFR = (1 << 16) + 128                       # probe_transpose's frames + halo
TRANSPOSE_FORMS = ((1, 32), (8, 2048), (8, 8192), (1, 8192))   # (P, L)
ROUNDS = 16          # alternated rounds of a copy and its PyTorch calls
# Candidate (b) of the 16-byte copy, which the "bulk" arm adds to probes.cu
# with its launch in sdsp_scale_copy_f32.
_BULK_KERNEL = r"""
// -- candidate (b) of the copy: TMA bulk copies and mbarriers

constexpr int kBulkChunk = 16384;     // bytes a bulk copy
constexpr int kBulkStages = 4;        // chunks in flight a block
constexpr int kBulkOut = 2;           // scaled chunks a block has in store
constexpr int kBulkBlocksPerSM = 2;

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the barrier's phase of this parity to complete; a copy that
// never lands traps after about ten seconds rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// y = s x over n floats in 16-byte vectors, candidate (b): persistent
// blocks, block k taking chunks k, k + G, ... of kBulkChunk bytes.  A chunk
// comes in by one bulk copy into a ring of kBulkStages stages (an mbarrier
// each), is scaled into one of kBulkOut output buffers, and goes out by one
// bulk copy from there, so its stage refills as soon as it is scaled.
// Block 0 also writes the n % 4 tail.
__global__ void __launch_bounds__(kCopyThreads)
scale_copy_bulk_kernel(const float* __restrict__ x, float* __restrict__ y,
                       long long n, float s) {
  constexpr int kVecs = kBulkChunk / 16;
  extern __shared__ __align__(128) float4 ring[];
  float4* out = ring + kBulkStages * kVecs;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(out + kBulkOut * kVecs);
  const int tid = threadIdx.x;
  const long long nvec = n / 4, blk = blockIdx.x, grid = gridDim.x;
  const long long chunks = (nvec + kVecs - 1) / kVecs;
  const long long mine = blk < chunks ? (chunks - blk + grid - 1) / grid : 0;
  auto first_of = [&](long long k) { return (blk + k * grid) * kVecs; };
  auto vecs_of = [&](long long k) {
    const long long left = nvec - first_of(k);
    return static_cast<unsigned>(left < kVecs ? left : kVecs);
  };
  auto issue = [&](long long k) {
    const int st = static_cast<int>(k % kBulkStages);
    mbar_expect(full + st, 16 * vecs_of(k));
    bulk_load(ring + st * kVecs, x + 4 * first_of(k), 16 * vecs_of(k),
              full + st);
  };
  if (tid == 0) {
    for (int st = 0; st < kBulkStages; ++st) mbar_init(full + st);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long k = 0; k < kBulkStages && k < mine; ++k) issue(k);
  }
  __syncthreads();
  for (long long k = 0; k < mine; ++k) {
    const int st = static_cast<int>(k % kBulkStages);
    float4* o = out + (k % kBulkOut) * kVecs;
    // The store of chunk k - kBulkOut has read o.
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kBulkOut - 1)
                   : "memory");
    }
    mbar_wait(full + st, static_cast<unsigned>((k / kBulkStages) & 1));
    __syncthreads();
    const unsigned nv = vecs_of(k);
    for (unsigned i = tid; i < nv; i += kCopyThreads) {
      o[i] = scaled(s, ring[st * kVecs + i]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(y + 4 * first_of(k), o, 16 * nv);
      if (k + kBulkStages < mine) issue(k + kBulkStages);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if (blk == 0) {
    for (long long i = 4 * nvec + tid; i < n; i += kCopyThreads) {
      y[i] = __fmul_rn(s, x[i]);
    }
  }
}

"""
_BULK_LAUNCH = r"""
  if (vec == 4) {
    constexpr size_t smem = (kBulkStages + kBulkOut) * kBulkChunk +
                            kBulkStages * sizeof(unsigned long long);
    err = cudaFuncSetAttribute(scale_copy_bulk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long chunks = (n / 4 + kBulkChunk / 16 - 1) / (kBulkChunk / 16);
    const long long most =
        static_cast<long long>(kBulkBlocksPerSM) * sm_count(device);
    const long long blocks = chunks < 1 ? 1 : (chunks < most ? chunks : most);
    scale_copy_bulk_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, smem,
                             st>>>(x, y, n, scale);
    return static_cast<int>(cudaGetLastError());
  }
"""
_PER_BLOCK = "  const long long per_block =\n"
# the transpose with one tile in shared memory: the next tile's copies
# issued after the stores
_SINGLE = [
    ("""    const float* here = stage + (k & 1) * a.tile;
    if (tn < a.tiles) {
      perm_load<kVec>(a, stage + ((k + 1) & 1) * a.tile, next, tid);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();""", """    const float* here = stage;
    cp_async_wait<0>();"""),
    ("""    __syncthreads();  // this stage is refilled next
    cur = next;""", """    __syncthreads();  // this stage is refilled next
    if (tn < a.tiles) perm_load<kVec>(a, stage, next, tid);
    cur = next;"""),
    ("constexpr size_t kPermSmem = 2 * sizeof(float) * kPermTile;",
     "constexpr size_t kPermSmem = sizeof(float) * kPermTile;"),
]


def _tile(floats: int):
    return ("constexpr int kPermTile = 8192;",
            f"constexpr int kPermTile = {floats};")


# name -> edits of probes.cu (a text, its replacement) and the arm's own
# arguments; "all" changes nothing.
VARIANTS = {
    "all": (None, ()),
    "bulk": ([("}  // namespace\n", _BULK_KERNEL + "}  // namespace\n"),
              (_PER_BLOCK, _BULK_LAUNCH.lstrip("\n") + _PER_BLOCK)], ()),
    "nohint": ([("constexpr bool kStreamHints = true;",
                 "constexpr bool kStreamHints = false;")], ()),
    "bytes32": ([("constexpr int kCopyBytes = 16;",
                  "constexpr int kCopyBytes = 32;")], ()),
    "bytes64": ([("constexpr int kCopyBytes = 16;",
                  "constexpr int kCopyBytes = 64;")], ()),
    "t128": ([("constexpr int kCopyThreads = 256;",
               "constexpr int kCopyThreads = 128;")], ()),
    "t512": ([("constexpr int kCopyThreads = 256;",
               "constexpr int kCopyThreads = 512;")], ()),
    "t1024": ([("constexpr int kCopyThreads = 256;",
                "constexpr int kCopyThreads = 1024;")], ()),
    "nopolicy": ([('"ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 '
                   '{%0, %1, %2, %3}, "\n      "[%4], %5;"',
                   '"ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, "'
                   '\n      "[%4];"')], ()),
    "wbstore": ([("    __stcs(p, v);", "    *p = v;")], ()),
    "single": (_SINGLE, ()),
    "tile4k": ([_tile(4096)], ("--tile", "4096")),
    "tile16k": ([_tile(16384)], ("--tile", "16384")),
    "single16k": (_SINGLE + [_tile(16384)], ("--tile", "16384")),
}


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def cases(probes, dev):
    """{case: (kernel call, plain call, {PyTorch call name: call}, bytes
    read and written)}, the inputs made on ``dev`` from fixed seeds."""
    import torch

    def randn(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    out = {}
    for name, shape in (("copy_f16384", (F, 32, 128)),
                        ("copy_wide", (F, 16, 128))):
        x = randn(shape, len(out))
        y = torch.empty_like(x)
        lib = {"torch.mul": lambda x=x: torch.mul(x, 2.0),
               "y.copy_(x)": lambda x=x, y=y: y.copy_(x)}
        widths = (16, 8, 4) if name == "copy_wide" else (16,)
        for v in widths:
            out[f"{name}_v{v}"] = (
                lambda x=x, v=v: probes.scale_copy(x, vec_bytes=v),
                lambda x=x: probes.scale_reference(x), lib if v == 16 else {},
                2 * x.numel() * 4)
    xt = randn((16, NFR, 16), 10)
    for p, lt in TRANSPOSE_FORMS:
        out[f"transpose_{p}_{lt}"] = (
            lambda p=p, lt=lt: probes.permute(xt, rows_per_block=lt,
                                              batch_per_block=p),
            lambda: probes.permute_reference(xt),
            {".transpose(-1, -2).contiguous()":
             lambda: xt.transpose(-1, -2).contiguous()}
            if (p, lt) == (1, 32) else {}, 2 * xt.numel() * 4)
    xr = randn((F, 16, 128), 11)
    out["regmix"] = (lambda: probes.permute(xr, 2.0),
                     lambda: probes.permute_reference(xr, 2.0),
                     {".transpose(-1, -2).contiguous() (no scale)":
                      lambda: xr.transpose(-1, -2).contiguous()},
                     2 * xr.numel() * 4)
    big4 = randn((32, 4096, 128), 12)
    out["k4"] = (lambda: probes.permute(big4.permute(1, 0, 2)),
                 lambda: probes.permute_reference(big4.permute(1, 0, 2)),
                 {".permute(1, 2, 0).contiguous()":
                  lambda: big4.permute(1, 2, 0).contiguous()},
                 2 * big4.numel() * 4)
    xj = randn((32, F, 128), 13)
    view = xj.permute(1, 0, 2)
    out["relayout"] = (lambda: probes.permute(view, split=True),
                       lambda: probes.permute_reference(view, split=True),
                       {".permute(1, 2, 0).contiguous()":
                        lambda: xj.permute(1, 2, 0).contiguous()},
                       2 * xj.numel() * 4)
    xc = randn((F, 32, 64), 14)
    out["relayout_chain"] = (lambda: probes.permute(xc),
                             lambda: probes.permute_reference(xc),
                             {".transpose(-1, -2).contiguous()":
                              lambda: xc.transpose(-1, -2).contiguous()},
                             2 * xc.numel() * 4)
    return out


def alternated(fns: dict, rounds: int = ROUNDS) -> dict:
    """{name: [ms a call, one a round]}: each function's graph of 20 calls
    replayed once a round, in the given order in even rounds and the
    reverse in odd ones."""
    from simpledsp_tpu_torch.tools._common import capture_graph, median_ms
    graphs = {k: capture_graph(f, 20) for k, f in fns.items()}
    out = {k: [] for k in graphs}
    for i in range(rounds):
        for k in (list(graphs) if i % 2 == 0 else list(graphs)[::-1]):
            out[k].append(median_ms(graphs[k].replay, reps=1) / 20)
    return out


def pairs(rounds: dict) -> dict:
    """Rounds won by the kernel over each PyTorch call, and each one's
    spread (max - min) over the rounds."""
    mine = rounds["kernel"]
    spread = {k: max(v) - min(v) for k, v in rounds.items()}
    return {name: {"kernel_wins": sum(a < b for a, b in zip(mine, ms)),
                   "rounds": len(ms),
                   "median_gap_ms": float(sorted(
                       b - a for a, b in zip(mine, ms))[len(ms) // 2]),
                   "kernel_spread_ms": spread["kernel"],
                   "its_spread_ms": spread[name]}
            for name, ms in rounds.items() if name != "kernel"}


def measure(root: str, csrc: str, build_only: bool = False,
            tile: int = 0) -> dict:
    """In this process: build ``csrc``'s probes.cu with the package of
    ``root`` and time every case."""
    sys.path.insert(0, root)
    import torch

    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import probes
    from simpledsp_tpu_torch.tools._common import graph_ms
    _build.CSRC_DIR = Path(csrc)
    probes.scale_copy_kernel.library()
    if build_only:
        return {}
    if tile:
        probes.PERMUTE_TILE = tile
    dev = torch.device("cuda", 0)
    out = {"ms": {}, "library_ms": {}, "bytes": {}, "bits": {}}
    for case, (kernel, plain, library, moved) in cases(probes, dev).items():
        got, want = kernel(), plain()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise RuntimeError(f"{case}: not equal to its plain version")
        del got, want
        out["ms"][case] = graph_ms(kernel)
        out["bytes"][case] = moved
        out["library_ms"][case] = {k: graph_ms(f) for k, f in library.items()}
        if case == "regmix":
            out["library_ms"][case]["plain (two passes)"] = graph_ms(plain)
        if case.startswith("copy") and case.endswith("_v16"):
            out.setdefault("rounds", {})[case] = alternated(
                {"kernel": kernel, **library})
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(64, 320, generator=gen, device=dev)
    b = torch.randn(320, 320, generator=gen, device=dev)
    x = torch.randn(2048, 128, generator=gen, device=dev)
    kt = torch.randn(10, 128, generator=gen, device=dev)
    sf = torch.randn(64, 10, generator=gen, device=dev)
    rows = torch.randn(16384, 320, generator=gen, device=dev)
    for case, fn in (("contract_k1", lambda: probes.contract(a, b)),
                     ("contract_k2", lambda: probes.contract(x, kt.T, sf=sf,
                                                             group=32)),
                     ("row_sum_k3", lambda: probes.row_sum(rows))):
        out["bits"][case] = _digest(fn())
        out["ms"][case] = graph_ms(fn)
    return out


def launch_shapes() -> list:
    """Each device activity of one call of the copy, ``torch.mul`` and
    ``y.copy_(x)`` at f = 16384, from one ``torch.profiler`` session's
    trace: [{call, name, kind, grid, block, us}]."""
    sys.path.insert(0, str(HERE))
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from simpledsp_tpu_torch.kernels import probes
    dev = torch.device("cuda", 0)
    x = torch.randn((F, 32, 128), device=dev)
    y = torch.empty_like(x)
    calls = {"scale_copy": lambda: probes.scale_copy(x),
             "torch.mul": lambda: torch.mul(x, 2.0),
             "y.copy_(x)": lambda: y.copy_(x)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            with record_function(f"copy_variants: {name}"):
                fn()
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=HERE / "build") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"].split(": ", 1)[1])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("copy_variants: "))
    out = []
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        owner = next((c for t0, t1, c in ranges if t0 <= e["ts"] <= t1), None)
        out.append({"call": owner, "name": e["name"], "kind": e["cat"],
                    "grid": e.get("args", {}).get("grid"),
                    "block": e.get("args", {}).get("block"),
                    "us": e.get("dur")})
    return out


def run(roots=None, variants=("all",), turns: int = 2) -> dict:
    sys.path.insert(0, str(HERE))
    from simpledsp_tpu_torch.tools._common import edited_csrc, time_in_turns
    arms = []
    for root in [Path(r).resolve() for r in (roots or [HERE])]:
        mine = root == HERE
        for v in (variants if mine else ("all",)):
            edits, own = VARIANTS[v] if mine else (None, ())
            csrc = edited_csrc(root, edits and {"probes.cu": edits},
                               f"probes_{v}")
            arms.append((f"{'this' if mine else root}@{v}", str(root),
                         str(csrc), own))
    out = time_in_turns(__file__, arms, turns)
    out["summary"], out["library_summary"] = {}, {}
    for r in out["runs"]:
        for case, ms in r["ms"].items():
            out["summary"].setdefault(r["arm"], {}).setdefault(
                case, []).append(ms)
        for case, lib in r["library_ms"].items():
            for name, ms in lib.items():
                out["library_summary"].setdefault(f"{case}: {name}",
                                                  []).append(ms)
    out["bytes"] = out["runs"][0]["bytes"]
    out["pairs"] = {}
    for r in out["runs"]:
        for case, rounds in r.get("rounds", {}).items():
            out["pairs"].setdefault(r["arm"], {}).setdefault(
                case, []).append(pairs(rounds))
    bits = {json.dumps(r["bits"], sort_keys=True) for r in out["runs"]}
    if len(bits) != 1:
        raise RuntimeError(f"contract / row_sum bits differ across arms: "
                           f"{bits}")
    outdir = Path("chiprun_out")
    if outdir.is_dir():
        (outdir / "copy_variants.json").write_text(json.dumps(out, indent=1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=None)
    ap.add_argument("--variants", nargs="+", default=["all"],
                    choices=list(VARIANTS))
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", nargs=2, default=None)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args()
    if a.child:
        print(json.dumps(measure(*a.child, build_only=a.build_only,
                                 tile=a.tile)))
        return 0
    out = run(a.roots, tuple(a.variants), a.turns)
    if a.trace:
        out["launch_shapes"] = launch_shapes()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
