"""The probes' kernels (simpledsp_tpu_torch.kernels.probes) against the
Pallas bodies of the JAX package's ``tools/probe_*.py``, on the CPU.

Each of the twelve TPU kernel bodies runs as a ``pallas_call`` inside
``force_tpu_interpret_mode()`` at a small size, and the port's entry on CPU
tensors (its plain version) runs on the same numpy-seeded input.  Only
``make_relayout`` is importable from ``tools/``; the other bodies live in
the probes' ``main()`` and are restated here word for word, each with its
``file:line``.

Tolerances: the copies and transposes give equal bits.  The products and
the row sum (probe_mosaic k1-k3) in float32: max |err| <= 1e-5 max |ref|
(float32 sums of up to 320 terms, summed in another order by the two).
The float64 plain versions against ``np.einsum``: 1e-12 of the largest
output.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from simpledsp_tpu_torch.kernels import probes
from tools.probe_relayout import make_relayout


def _t(a):
    return torch.as_tensor(np.array(a))


def _same(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == _t(want).dtype
    assert np.array_equal(got.numpy(), want)


def _near(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _copy_call(body, shape, blk, grid, index_map):
    """A pallas_call of ``body`` over one input and one output of ``shape``
    in ``blk`` blocks."""
    spec = pl.BlockSpec(blk, index_map, memory_space=pltpu.VMEM)
    return pl.pallas_call(body, grid=(grid,), in_specs=[spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.float32))


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- scale_copy --------------------------------------------------------------

@pytest.mark.parametrize("grid", [1, 16])
def test_dispatch_body(grid, rng, interpret):
    """tools/probe_dispatch.py:30 (call :35): every grid step rewrites the
    same (8, 128) tile."""
    def body(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    x = _x(rng, (8, 128))
    want = _copy_call(body, (8, 128), (8, 128), grid, lambda i: (0, 0))(
        jnp.asarray(x))
    _same(probes.scale_copy(_t(x), same_tile_blocks=grid), want)


def _dma_body(x_ref, o_ref):
    """tools/probe_dma_scale.py:18."""
    o_ref[:] = x_ref[:] * 2.0


@pytest.mark.parametrize("vec_bytes", [4, 16])
def test_dma_scale_body(vec_bytes, rng, interpret):
    """tools/probe_dma_scale.py:18 (call :26) at f = 8, r = 2 frames a
    step."""
    f, n1, n2, r = 8, 32, 128, 2
    x = _x(rng, (f, n1, n2))
    want = _copy_call(_dma_body, (f, n1, n2), (r, n1, n2), f // r,
                      lambda i: (i, 0, 0))(jnp.asarray(x))
    _same(probes.scale_copy(_t(x), vec_bytes=vec_bytes), want)


def test_dma_scale_two_chained(rng, interpret):
    """tools/probe_dma_scale.py:55: the same copy twice in one program."""
    f, n1, n2, r = 8, 32, 128, 2

    def one(a):
        return _copy_call(_dma_body, (f, n1, n2), (r, n1, n2), f // r,
                          lambda i: (i, 0, 0))(a)

    x = _x(rng, (f, n1, n2))
    want = jax.jit(lambda a: one(one(a)))(jnp.asarray(x))
    _same(probes.scale_copy(probes.scale_copy(_t(x))), want)


@pytest.mark.parametrize("shape,blk", [((16, 16, 128), (4, 16, 128)),
                                       ((16, 64, 32), (4, 64, 32))],
                         ids=["wide", "narrow"])
def test_store_body_copy(shape, blk, rng, interpret):
    """tools/probe_store.py:59 (call :32), wide and narrow at f = 16."""
    def body_copy(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    x = _x(rng, shape)
    want = _copy_call(body_copy, shape, blk, shape[0] // blk[0],
                      lambda i: (i, 0, 0))(jnp.asarray(x))
    _same(probes.scale_copy(_t(x), vec_bytes=8), want)


def test_hlo_body(rng, interpret):
    """tools/probe_hlo.py:17 (call :21) at f_total = 8, r = 4."""
    f_total, n1, n2, r = 8, 32, 128, 4

    def body(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    x = _x(rng, (f_total, n1, n2))
    want = _copy_call(body, (f_total, n1, n2), (r, n1, n2), f_total // r,
                      lambda i: (i, 0, 0))(jnp.asarray(x))
    _same(probes.scale_copy(_t(x)), want)


# -- permute -----------------------------------------------------------------

def test_store_body_regmix(rng, interpret):
    """tools/probe_store.py:68 (call :32): y = 2 x^T per frame, f = 16."""
    f, r = 16, 4

    def body_regmix(x_ref, o_ref):
        o_ref[:] = jnp.transpose(x_ref[:] * 2.0, (0, 2, 1))

    x = _x(rng, (f, 16, 128))
    want = pl.pallas_call(
        body_regmix, grid=(f // r,),
        in_specs=[pl.BlockSpec((r, 16, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((r, 128, 16), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((f, 128, 16), jnp.float32))(
            jnp.asarray(x))
    _same(probes.permute(_t(x), 2.0), want)


@pytest.mark.parametrize("n1,n2,f,r", [(8, 128, 8, 8), (32, 128, 16, 4)])
def test_relayout_body(n1, n2, f, r, rng, interpret):
    """tools/probe_relayout.py:27 ``make_relayout`` (body :33, call :44):
    (n1, f, n2) -> the (f, n2/2, n1) re and im planes."""
    x = _x(rng, (n1, f, n2))
    want_r, want_i = make_relayout(n1, n2, r)(jnp.asarray(x))
    got_r, got_i = probes.permute(_t(x).permute(1, 0, 2), split=True)
    _same(got_r, want_r)
    _same(got_i, want_i)


@pytest.mark.parametrize("pack,lt", [(2, 16), (1, 32)])
def test_transpose_body(pack, lt, rng, interpret):
    """tools/probe_transpose.py:82 (call :116): (L, M) tiles through a
    2-slot DMA ring, P streams packed: (B, nfr, M) -> (B / P, P M, nfr);
    B = 4, M = 16, nfr = 64."""
    b, m, nfr = 4, 16, 64
    pm = pack * m
    ntiles = nfr // lt
    total = (b // pack) * ntiles
    x3 = jnp.asarray(_x(rng, (b, nfr, m)))

    def body(x_ref, o_ref, scr, sem, pack=pack, lt=lt, ntiles=ntiles,
             total=total, pm=pm):
        s = pl.program_id(0)
        i32 = lambda v: jnp.asarray(v, s.dtype)  # noqa: E731

        def dma(step, slot):
            bb = step // i32(ntiles)
            ii = step - bb * i32(ntiles)
            return pltpu.make_async_copy(
                x_ref.at[bb * i32(pack), pl.ds(ii * i32(lt), lt), :]
                if pack == 1 else
                x_ref.at[pl.ds(bb * i32(pack), pack),
                         pl.ds(ii * i32(lt), lt), :],
                scr.at[slot], sem.at[slot])

        @pl.when(s == 0)
        def _():
            dma(i32(0), 0).start()

        @pl.when(s + 1 < total)
        def _():
            dma(s + i32(1), jax.lax.rem(s + i32(1), i32(2))).start()

        slot = jax.lax.rem(s, i32(2))
        dma(s, slot).wait()
        if pack == 1:
            o_ref[0] = jnp.transpose(scr[slot], (1, 0))
        else:
            v = scr[slot]                     # (pack, lt, m)
            parts = [jnp.transpose(v[q], (1, 0)) for q in range(pack)]
            o_ref[0] = jax.lax.concatenate(parts, 0)

    scr_shape = (2, lt, m) if pack == 1 else (2, pack, lt, m)
    want = pl.pallas_call(
        body, grid=(total,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(
            (1, pm, lt), lambda s: (s // ntiles, 0, s % ntiles)),
        out_shape=jax.ShapeDtypeStruct((b // pack, pm, nfr), jnp.float32),
        scratch_shapes=[pltpu.VMEM(scr_shape, jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
    )(x3)
    got = probes.permute(_t(x3), rows_per_block=32, batch_per_block=pack)
    _same(got.view(b // pack, pm, nfr), want)


def test_mosaic_k4_body(rng, interpret):
    """tools/probe_mosaic.py:129 k4 (call :133): (n1, f, n2) -> (f, n2, n1)
    at n1 = 32, f = 64, r = 16."""
    r, n1, n2, f = 16, 32, 128, 64

    def k4(x_ref, o_ref):
        o_ref[:] = jnp.transpose(x_ref[:], (1, 2, 0))

    big = _x(rng, (n1, f, n2))
    want = pl.pallas_call(
        k4, grid=(f // r,),
        in_specs=[pl.BlockSpec((n1, r, n2), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((r, n2, n1), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((f, n2, n1), jnp.float32),
    )(jnp.asarray(big))
    _same(probes.permute(_t(big).permute(1, 0, 2)), want)


# -- contract and row_sum (probe_mosaic k1-k3) --------------------------------

R, NB, D = 16, 32, 10


def _mosaic_k1(kxx, u4):
    """tools/probe_mosaic.py:36 k1 (call :44)."""
    def k1(kxx_ref, u4_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(
            kxx_ref[:], u4_ref[:],
            dimension_numbers=(((1, 2), (0, 1)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)

    return pl.pallas_call(
        k1, grid=(4,),
        in_specs=[pl.BlockSpec((R, NB, D), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((NB, D, NB, D), lambda i: (0, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((R, NB, D), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((64, NB, D), jnp.float32),
    )(kxx, u4)


def _mosaic_k2(x, sf, kt):
    """tools/probe_mosaic.py:62 k2 (call :74)."""
    def k2(x_ref, sf_ref, kt_ref, o_ref):
        dot_lane = functools.partial(
            jax.lax.dot_general,
            dimension_numbers=(((2,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        kx = dot_lane(x_ref[:], kt_ref[:])        # (r, nb, d)
        kxx = jnp.concatenate([sf_ref[:][:, None, :], kx[:, :NB - 1]],
                              axis=1)
        o_ref[:] = kxx

    return pl.pallas_call(
        k2, grid=(4,),
        in_specs=[pl.BlockSpec((R, NB, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((R, D), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((D, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((R, NB, D), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((64, NB, D), jnp.float32),
    )(x, sf, kt)


def _mosaic_k3(big):
    """tools/probe_mosaic.py:97 k3 (call :101), over (f, 32, 10)."""
    f = big.shape[0]

    def k3(s_ref, o_ref):
        o_ref[:] = jnp.sum(s_ref[:], axis=(1, 2), keepdims=True)[:, :, 0]

    return pl.pallas_call(
        k3, grid=(f // R,),
        in_specs=[pl.BlockSpec((R, NB, D), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((R, 1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((f, 1), jnp.float32),
    )(big)


@pytest.fixture
def mosaic_inputs():
    """The JAX probe's operands, numpy seed 0 in its order, float32."""
    rng = np.random.default_rng(0)
    shapes = {"kxx": (64, NB, D), "u4": (NB, D, NB, D), "x": (64, NB, 128),
              "sf": (64, D), "kt": (D, 128), "big": (256, NB, D)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_mosaic_k1_body(mosaic_inputs, interpret):
    a = mosaic_inputs
    want = _mosaic_k1(jnp.asarray(a["kxx"]), jnp.asarray(a["u4"]))
    got = probes.contract(_t(a["kxx"]).reshape(64, NB * D),
                          _t(a["u4"]).reshape(NB * D, NB * D))
    _near(got.view(64, NB, D), want)


def test_mosaic_k2_body(mosaic_inputs, interpret):
    a = mosaic_inputs
    want = _mosaic_k2(*(jnp.asarray(a[k]) for k in ("x", "sf", "kt")))
    got = probes.contract(_t(a["x"]).reshape(64 * NB, 128), _t(a["kt"]).T,
                          sf=_t(a["sf"]), group=NB)
    _near(got.view(64, NB, D), want)
    # The shifted rows are the bits of the product's rows.
    prod = probes.contract(_t(a["x"]).reshape(64 * NB, 128), _t(a["kt"]).T)
    assert torch.equal(got.view(64, NB, D)[:, 1:],
                       prod.view(64, NB, D)[:, :-1])
    assert torch.equal(got.view(64, NB, D)[:, 0], _t(a["sf"]))


def test_mosaic_k3_body(mosaic_inputs, interpret):
    big = mosaic_inputs["big"]
    want = _mosaic_k3(jnp.asarray(big))
    got = probes.row_sum(_t(big).reshape(big.shape[0], -1))
    _near(got.view(-1, 1), want)


def test_float64_plain_versions_match_einsum(mosaic_inputs):
    """contract_reference (with and without the shift) and row_sum_reference
    in float64 against np.einsum, 1e-12 of the largest output."""
    a = {k: v.astype(np.float64) for k, v in mosaic_inputs.items()}

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())

    k1 = np.einsum("rje,jepd->rpd", a["kxx"], a["u4"])
    close(probes.contract_reference(_t(a["kxx"]).reshape(64, -1),
                                    _t(a["u4"]).reshape(NB * D, -1)
                                    ).view(64, NB, D), k1)
    kx = np.einsum("rjt,dt->rjd", a["x"], a["kt"])
    k2 = np.concatenate([a["sf"][:, None, :], kx[:, :NB - 1]], axis=1)
    close(probes.contract_reference(_t(a["x"]).reshape(64 * NB, 128),
                                    _t(a["kt"]).T, _t(a["sf"]), NB
                                    ).view(64, NB, D), k2)
    close(probes.row_sum_reference(_t(a["big"]).reshape(256, -1)),
          np.einsum("fjd->f", a["big"]))


# -- the entries' contract ----------------------------------------------------

def test_entries_raise_on_what_they_do_not_take():
    x = torch.zeros(4, 32, 8)
    with pytest.raises(ValueError, match="vec_bytes"):
        probes.scale_copy(x, vec_bytes=12)
    with pytest.raises(ValueError, match="same_tile_blocks"):
        probes.scale_copy(x, same_tile_blocks=-1)
    with pytest.raises(ValueError, match="rows_per_block"):
        probes.permute(x, rows_per_block=48)
    with pytest.raises(ValueError, match="even C"):
        probes.permute(torch.zeros(2, 3, 5), split=True)
    with pytest.raises(ValueError, match=r"\(B, R, C\)"):
        probes.permute(torch.zeros(3, 5))
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        probes.contract(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="group"):
        probes.contract(torch.zeros(6, 3), torch.zeros(3, 2),
                        sf=torch.zeros(1, 2), group=4)
    with pytest.raises(ValueError, match="rows, cols"):
        probes.row_sum(torch.zeros(3))
    meta = torch.empty(2, 32, 8, device="meta")
    for call in (lambda: probes.scale_copy(meta), lambda: probes.permute(meta),
                 lambda: probes.row_sum(meta[0]),
                 lambda: probes.contract(meta[0], meta[0].T)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_cpu_entries_never_reach_a_kernel(monkeypatch, rng):
    """CPU tensors take the plain versions, never a kernel wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA kernel wrapper was called")
    for name in ("scale_copy_kernel", "permute_kernel", "contract_kernel",
                 "row_sum_kernel"):
        monkeypatch.setattr(probes, name, refuse)
    x = torch.as_tensor(_x(rng, (4, 32, 8)))
    assert torch.equal(probes.scale_copy(x), x * 2.0)
    assert torch.equal(probes.permute(x), x.transpose(1, 2))
    assert probes.contract(x[0], x[0].T).shape == (32, 32)
    assert torch.equal(probes.row_sum(x[0]), x[0].sum(-1))


# -- the contraction kernel's plan and layout (csrc/probes.cu) -----------------

@pytest.mark.parametrize("m,n,k,want", [
    (64, 320, 320, ("tiled", 10)),        # k1 at the probe's size: split K
    (16384, 320, 320, ("tiled", 1)),      # k1 at the chain's size
    (2048, 10, 128, ("skinny", 1)),       # k2 at the probe's size
    (524288, 10, 128, ("skinny", 1)),     # k2 at the chain's size
    (3000, 16, 64, ("skinny", 1)), (3000, 17, 64, ("tiled", 2)),
    (64, 17, 320, ("tiled", 10)), (256, 40, 1000, ("tiled", 1)),
    (256, 40, 512, ("tiled", 16)),
    (64, 320, 32, ("tiled", 1)), (100, 20, 0, ("tiled", 1))])
def test_contract_plan_picks_the_form(m, n, k, want):
    assert probes.contract_plan(m, n, k, 132) == want


@pytest.mark.parametrize("sms", [1, 8, 78, 132])
def test_contract_plan_splits_are_whole(sms):
    """A split launch gives every K step a block of its own (so each block's
    total is one step's partial, and the tile's cluster adds them in K
    order: the unsplit sum's bits), and splits only where the tiles leave
    SMs idle and the steps fit one cluster."""
    for m in (1, 64, 65, 300, 4096):
        for n in (17, 64, 320, 1000):
            for k in (0, 1, 32, 33, 320, 512, 513, 5000):
                form, splits = probes.contract_plan(m, n, k, sms)
                tiles = (-(-m // probes.TILE_M)) * -(-n // probes.TILE_N)
                steps = -(-k // probes.K_STEP)
                assert form == "tiled" and splits >= 1
                if splits > 1:
                    assert tiles < sms and splits == steps
                    assert steps <= probes.MAX_SPLIT_STEPS
                else:
                    assert (tiles >= sms or steps < 2
                            or steps > probes.MAX_SPLIT_STEPS)


def _groups_free(addr):
    """A quarter-warp's eight 16-byte accesses (float addresses) are equal
    or fall in eight distinct bank groups."""
    a = np.asarray(addr)
    assert (a % 4 == 0).all()
    return len(set(a.tolist())) == 1 or len(set(((a // 4) % 8).tolist())) == 8


def test_contract_shared_memory_reads_have_no_bank_conflict():
    """The tiled form's A and B reads (thread t of 128: row thread
    ty = t >> 4, rows ty + 8 i; column thread tx = t & 15, columns
    4 tx ..) and the skinny form's A reads (lane l: row l) at every 4-deep
    k, a quarter-warp at a time; a warp's tiled A reads (two rows) also fit
    one wavefront of distinct bank groups."""
    lanes = np.arange(32)
    cols = probes.TILE_N // 4
    for warp in range(4):
        tid = 32 * warp + lanes
        ty, tx = tid // cols, tid % cols
        for kk in range(0, probes.K_STEP, 4):
            for i in range(8):
                a = (ty + (probes.TILE_M // 8) * i) * probes.A_PITCH + kk
                for q in range(4):
                    assert _groups_free(a[8 * q: 8 * q + 8])
                assert len(set(((a // 4) % 8).tolist())) == len(set(a.tolist()))
            for q in range(4):
                b = (kk + q) * probes.B_PITCH + 4 * tx
                for g in range(4):
                    assert _groups_free(b[8 * g: 8 * g + 8])
        a = lanes * probes.A_PITCH
        for kk in range(0, probes.K_STEP, 4):
            for q in range(4):
                assert _groups_free(a[8 * q: 8 * q + 8] + kk)


@pytest.mark.parametrize("probe", ["probe_dma_scale", "probe_store",
                                   "probe_dispatch", "probe_hlo",
                                   "probe_transpose", "probe_relayout",
                                   "probe_mosaic"])
def test_probes_need_the_card(probe):
    """A probe measures the card: on the CPU it raises, it does not fall
    back to a plain version."""
    import importlib
    module = importlib.import_module(f"simpledsp_tpu_torch.tools.{probe}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.run("cpu")
