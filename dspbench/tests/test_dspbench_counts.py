"""The roofline counts against hand counts at small shapes."""

import math

import pytest

from dspbench import roofline


def test_chain_work_by_hand():
    # 2 channels x 16 samples, 8-point frames, 3 sections, 8 state values.
    w = roofline.chain_work(2, 16, 8, 3, 8)
    frames = 2 * 16 // 8
    flops = 32 * 3 * 9 + frames * 2.5 * 8 * 3
    nbytes = 4 * (32 + frames * 8 + 2 * 2 * 8)
    assert w == {"flops": pytest.approx(flops), "bytes": pytest.approx(nbytes)}


def test_pfb_fm_work_by_hand():
    # 3 streams x 32 complex samples, M 4, K 2, decim 2, 6 audio taps.
    w = roofline.pfb_fm_work(3, 32, 4, 2, 2, 6)
    per = 4 * 2 + 5 * 2 + 6 + 2 * 6 / 2
    assert w["flops"] == pytest.approx(96 * per)
    assert w["bytes"] == pytest.approx(4 * (2 * 96 + 48))


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_the_main_cells_are_bytes_bound():
    chain = roofline.chain_work(64, 1 << 20, 4096, 4, 10)
    assert roofline.bound_s(chain["flops"], chain["bytes"]) == pytest.approx(
        (2 * 64 * (1 << 20) + 2 * 64 * 10) * 4 / 3.35e12)
    bank = roofline.pfb_fm_work(16, 1 << 20, 16, 16, 4, 64)
    assert roofline.bound_s(bank["flops"], bank["bytes"]) == pytest.approx(
        bank["bytes"] / 3.35e12)
    assert roofline.real_fft_flops(4096) == 2.5 * 4096 * math.log2(4096)
